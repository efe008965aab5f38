"""``paddle_tpu_torch.Model`` (hapi) over LeNet against
``paddle_tpu.Model`` on the same data: the reference's synthetic MNIST
(64 training and 32 test images), the same numpy initial weights carried
by `convert`, the same ``np.random`` seed before each loop (the loaders
shuffle with numpy's global RNG in both packages), ``shuffle=True``.

Bars: each batch's loss within 1e-4 (fp32; cuDNN-free CPU convolutions
sum in another order than XLA's), ``acc`` equal (the accuracy counts
argmax hits, which agree while the logits agree to 1e-4: the check
fails loudly if a near-tie flips), ``predict``'s outputs within 1e-4;
the callbacks' order equal to the reference's; ``EarlyStopping`` and
``LRScheduler`` stopping and stepping as the reference's; ``summary`` /
``flops`` totals equal; ``.pdparams`` crossing both ways bit for bit,
the reference's ``.pdopt`` loading into the port, and the port's own
save / load round trip bit for bit. ``ModelCheckpoint``
(``fit(save_dir=...)``) and ``num_workers > 0`` must raise, naming
their ROADMAP items.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.hapi.callbacks as jcallbacks
import paddle_tpu.io as jio
import paddle_tpu.metric as jmetric
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as popt
from paddle_tpu.vision.datasets import MNIST as JMNIST
from paddle_tpu.vision.models import LeNet as JLeNet
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch import io as pio
from paddle_tpu_torch import metric as pmetric
from paddle_tpu_torch.hapi import callbacks as pcallbacks
from paddle_tpu_torch.hapi import InputSpec
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.optimizer.lr import StepDecay
from paddle_tpu_torch.vision.datasets import MNIST
from paddle_tpu_torch.vision.models import LeNet

LOSS_TOL = 1e-4
J = dict(io=jio, metric=jmetric, cb=jcallbacks, Model=paddle.Model)
P = dict(io=pio, metric=pmetric, cb=pcallbacks, Model=pt.Model)


def _nets(seed=0):
    """(reference LeNet, port LeNet) with the same numpy weights."""
    paddle.seed(0)
    jnet = JLeNet()
    rng = np.random.default_rng(seed)
    named = {}
    for name, p in jnet.named_parameters():
        a = (rng.standard_normal(tuple(p.shape)) * 0.1).astype(np.float32)
        p._data = jnp.asarray(a)
        named[name] = a
    tnet = LeNet(device="cpu")
    tnet.load_state_dict(convert.state_dict_from_jax(named, model=tnet))
    return jnet, tnet


def _data(pkg):
    mnist = JMNIST if pkg is J else MNIST
    return (pkg["io"].Subset(mnist(mode="train"), range(64)),
            pkg["io"].Subset(mnist(mode="test"), range(32)))


def _models(lr=1e-3, metrics=True):
    jnet, tnet = _nets()
    jm = paddle.Model(jnet)
    jm.prepare(popt.Adam(learning_rate=lr, parameters=jnet.parameters()),
               jnn.CrossEntropyLoss(),
               jmetric.Accuracy() if metrics else None)
    tm = pt.Model(tnet)
    tm.prepare(Adam(learning_rate=lr, parameters=tnet.parameters()),
               CrossEntropyLoss(), pmetric.Accuracy() if metrics else None)
    return jm, tm


def _recorder(pkg):
    """A callback that records every hook it sees and each batch's
    logs."""
    class Recorder(pkg["cb"].Callback):
        def __init__(self):
            super().__init__()
            self.calls, self.losses, self.accs = [], [], []

        def __getattribute__(self, name):
            if name.startswith("on_"):
                calls = object.__getattribute__(self, "calls")
                calls.append(name)
            return object.__getattribute__(self, name)

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(np.atleast_1d(logs["loss"])[0]))
            self.accs.append(logs.get("acc"))
    return Recorder()


def _fit(pkg, model, **kw):
    train, test = _data(pkg)
    rec = _recorder(pkg)
    np.random.seed(0)
    model.fit(train, eval_data=test, batch_size=16, epochs=2, verbose=0,
              shuffle=True, callbacks=[rec], **kw)
    return rec


def test_fit_evaluate_predict_match_the_reference():
    jm, tm = _models()
    jr, tr = _fit(J, jm), _fit(P, tm)
    assert len(tr.losses) == len(jr.losses) == 8
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=0, atol=LOSS_TOL)
    assert tr.accs == jr.accs
    assert tr.calls == jr.calls              # the callbacks' order
    _, jtest = _data(J)
    _, ttest = _data(P)
    want = jm.evaluate(jtest, batch_size=16, verbose=0)
    got = tm.evaluate(ttest, batch_size=16, verbose=0)
    assert got["acc"] == want["acc"]
    assert abs(got["loss"][0] - want["loss"][0]) < LOSS_TOL
    jp = jm.predict(jtest, batch_size=16, stack_outputs=True)
    tp = tm.predict(ttest, batch_size=16, stack_outputs=True)
    assert tp[0].shape == (32, 10) and isinstance(tp[0], np.ndarray)
    np.testing.assert_allclose(tp[0], np.asarray(jp[0]), rtol=0,
                               atol=LOSS_TOL)
    # evaluate's acc is a recount of predict's argmax
    labels = np.concatenate([ttest[i][1] for i in range(32)])
    assert got["acc"] == float((tp[0].argmax(1) == labels).mean())
    unstacked = tm.predict(ttest, batch_size=16)
    assert len(unstacked) == 2 and unstacked[0][0].shape == (16, 10)


def test_prefetch_and_deferred_losses_change_nothing():
    """``prefetch=True`` stages through a `DevicePrefetcher` (the CPU
    here) and leaves ``input_pipeline_stats``; without metrics or user
    callbacks the loss stays on the device between log boundaries."""
    runs = []
    for prefetch in (False, True):
        _, tm = _models(metrics=False)
        train, _ = _data(P)
        np.random.seed(0)
        tm.fit(train, batch_size=16, epochs=1, verbose=0, prefetch=prefetch)
        runs.append([p.detach().clone() for p in tm.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert tm.input_pipeline_stats["batches"] == 4
    out = tm.train_batch([np.zeros((2, 1, 28, 28), np.float32)],
                         [np.zeros((2, 1), np.int64)], sync=False)
    assert isinstance(out[0], torch.Tensor) and not out[0].requires_grad
    host = tm.train_batch([torch.zeros(2, 1, 28, 28)],
                          [torch.zeros(2, 1, dtype=torch.int64)])
    assert isinstance(host[0], float)


def test_early_stopping_and_lr_scheduler_follow_the_reference():
    epochs = []
    lasts = []
    for pkg in (J, P):
        jm, tm = _models(lr=0.0)
        model = jm if pkg is J else tm
        stop = pkg["cb"].EarlyStopping(monitor="acc", mode="max",
                                       patience=0)
        rec = _recorder(pkg)
        train, test = _data(pkg)
        np.random.seed(0)
        model.fit(train, eval_data=test, batch_size=16, epochs=5,
                  verbose=0, callbacks=[stop, rec])
        epochs.append(rec.calls.count("on_epoch_end"))
        net = model.network
        sched_cls = popt.lr.StepDecay if pkg is J else StepDecay
        sched = sched_cls(learning_rate=0.1, step_size=3)
        opt = (popt.Adam if pkg is J else Adam)(
            learning_rate=sched, parameters=net.parameters())
        model.prepare(opt, model._loss)
        np.random.seed(0)
        model.fit(train, batch_size=16, epochs=2, verbose=0,
                  callbacks=[pkg["cb"].LRScheduler()])
        lasts.append((sched.last_epoch, sched.get_lr()))
    assert epochs[0] == epochs[1] == 2
    assert lasts[0] == lasts[1] == (8, 0.1 * 0.1 ** 2)


def test_summary_and_flops_totals_equal_the_reference(capsys):
    jnet, tnet = _nets()
    want = paddle.summary(jnet, (1, 1, 28, 28))
    got = pt.summary(tnet, (1, 1, 28, 28))
    assert got == want == {"total_params": 61610,
                           "trainable_params": 61610}
    assert pt.flops(tnet, (1, 1, 28, 28)) == paddle.flops(jnet,
                                                          (1, 1, 28, 28))
    x = torch.zeros(2, 1, 28, 28)
    assert pt.flops(tnet, inputs=x) == 2 * pt.flops(tnet, (1, 1, 28, 28))
    assert pt.summary(tnet, input=x) == got
    jm, tm = _models()
    assert tm.summary() == jm.summary()
    assert "features.0" in capsys.readouterr().out
    with pytest.raises(ValueError, match="input_size"):
        pt.flops(tnet)
    assert repr(InputSpec([None, 1, 28, 28], name="x")).startswith(
        "InputSpec(shape=[None, 1, 28, 28]")


def _bits(t):
    return t.detach().cpu().numpy().tobytes()


def test_pdparams_cross_both_ways_and_round_trip(tmp_path):
    jm, tm = _models()
    train, _ = _data(P)
    np.random.seed(0)
    tm.fit(train, batch_size=16, epochs=1, verbose=0)
    tm.save(str(tmp_path / "port"))
    # the port keys its .pdopt param_<rank>: a reference optimizer finds
    # its state there only when its model was the process's first, so
    # the reference takes the parameters alone
    jm.load(str(tmp_path / "port"), reset_optimizer=True)
    want = convert.state_dict_to_jax(tm.network.state_dict(),
                                     model=tm.network)
    for name, p in jm.network.named_parameters():
        assert np.asarray(p._data).tobytes() == want[name].tobytes(), name
    # the port's own round trip, optimizer state included
    _, again = _models()
    again.load(str(tmp_path / "port"))
    for a, b in zip(again.network.state_dict().values(),
                    tm.network.state_dict().values()):
        assert _bits(a) == _bits(b)
    sa, sb = again._optimizer.state_dict(), tm._optimizer.state_dict()
    assert sa["step"] == sb["step"] == 4
    for acc, store in sb["accumulators"].items():
        for key, v in store.items():
            assert _bits(sa["accumulators"][acc][key]) == _bits(v)
    # the reference's files into the port
    jtrain, _ = _data(J)
    np.random.seed(0)
    jm.fit(jtrain, batch_size=16, epochs=1, verbose=0)
    jm.save(str(tmp_path / "ref"))
    _, fresh = _models()
    fresh.load(str(tmp_path / "ref"))
    want = convert.state_dict_from_jax(
        {n: np.asarray(p._data) for n, p in jm.network.named_parameters()},
        model=fresh.network)
    for name, p in fresh.network.named_parameters():
        assert _bits(p) == _bits(want[name]), name
    assert fresh._optimizer._step_count == 4
    fresh.load(str(tmp_path / "ref"), reset_optimizer=True)


def test_unported_pieces_raise():
    _, tm = _models()
    train, _ = _data(P)
    with pytest.raises(NotImplementedError, match="A8"):
        tm.fit(train, batch_size=16, save_dir="somewhere", verbose=0)
    with pytest.raises(NotImplementedError, match="A8"):
        pcallbacks.ModelCheckpoint(1, "somewhere")
    with pytest.raises(NotImplementedError, match="A10b"):
        tm.fit(train, batch_size=16, num_workers=2, verbose=0)
    with pytest.raises(TypeError, match="Metric"):
        tm.prepare(metrics=[object()])
    tm.prepare(tm._optimizer, tm._loss, amp_configs={"level": "O2",
                                                     "dtype": "float16"})
    assert tm._amp_level == "O2" and tm._scaler is not None
    _, tm = _models()
    tm.prepare(tm._optimizer, tm._loss, amp_configs="O2")
    assert tm._amp_level == "O2" and tm._scaler is None
