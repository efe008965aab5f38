"""The port's FLAGS registry (`paddle_tpu_torch.utils.flags`) against the
reference's (`paddle_tpu.utils.flags`): the same calls on both give the
same values and the same errors. Flags these tests define or register
are removed from both registries afterwards."""
import pytest

from paddle_tpu.utils import flags as jflags
import paddle_tpu_torch
from paddle_tpu_torch.utils import flags as tflags

BOTH = (jflags, tflags)


@pytest.fixture
def scratch_flags():
    names = []
    yield names
    for mod in BOTH:
        for n in names:
            mod._registry.pop(n, None)


@pytest.mark.parametrize("default,env,want", [
    (False, "1", True), (False, "TRUE", True), (True, "off", False),
    (True, "0", False), (False, "yes", True), (3, "17", 17),
    (0.5, "0.25", 0.25), ("", "int8", "int8")])
def test_environment_overrides_the_default_at_definition(
        monkeypatch, scratch_flags, default, env, want):
    name = f"FLAGS_torch_test_env_{type(default).__name__}"
    scratch_flags.append(name)
    monkeypatch.setenv(name, env)
    got = [mod.define_flag(name, default, "test") for mod in BOTH]
    assert got == [want, want]
    assert [mod.get_flags(name) for mod in BOTH] == [{name: want}] * 2
    monkeypatch.delenv(name)
    assert [mod.define_flag(name, default) for mod in BOTH] == [default] * 2


@pytest.mark.parametrize("default,value,want", [
    (True, "false", False), (True, 0, False), (False, "on", True),
    (4, "9", 9), (4, 2.7, 2), (1.0, "3", 3.0), ("a", 5, 5)])
def test_set_flags_coerces_to_the_default_type(scratch_flags, default,
                                               value, want):
    name = "FLAGS_torch_test_coerce"
    scratch_flags.append(name)
    for mod in BOTH:
        mod.define_flag(name, default)
        mod.set_flags({name: value})
    got = [mod.get_flag(name) for mod in BOTH]
    assert got == [want, want] and type(got[0]) is type(got[1])


def test_unknown_names(scratch_flags):
    """get_flags raises on an unknown name, get_flag gives None, and
    set_flags registers one with its value as the default."""
    name = "FLAGS_torch_test_phasing_in"
    scratch_flags.append(name)
    for mod in BOTH:
        with pytest.raises(ValueError, match="unknown flag"):
            mod.get_flags([name])
        assert mod.get_flag(name) is None
        mod.set_flags({name: "7"})
        assert mod.get_flags([name]) == {name: "7"}
        mod.set_flags({name: 8})           # a str default: no coercion
        assert mod.get_flag(name) == 8


def test_the_port_defines_the_flags_its_routes_consult():
    """``FLAGS_splash_attn`` and ``FLAGS_pallas_flash_min_seqlen`` (the
    attention routing's length gate), each with the reference's default
    and help."""
    for name in ("FLAGS_splash_attn", "FLAGS_pallas_flash_min_seqlen"):
        assert tflags._registry[name]["default"] == \
            jflags._registry[name]["default"], name
        assert tflags._registry[name]["help"] == \
            jflags._registry[name]["help"], name
    assert tflags._registry["FLAGS_pallas_flash_min_seqlen"]["default"] \
        == 1024
    assert paddle_tpu_torch.get_flags is tflags.get_flags
    assert paddle_tpu_torch.set_flags is tflags.set_flags
