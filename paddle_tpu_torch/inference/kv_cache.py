"""KV caches for the decode engines: paged pools (fp, int8, int4) and the
dense per-slot cache.

Counterpart of paddle_tpu/inference/kv_cache.py:

* ``PagedKVCache``: the Ragged-Paged-Attention layout, per layer K/V
  page pools ``[num_kv_heads, num_pages, page_size, head_dim]`` (the
  ops/kernels/paged_attention.py contract), per-slot page tables and
  ragged ``seq_lens``. Slots allocate and free independently
  (continuous batching). ``quant="int8"`` stores the pools as int8 with
  one fp32 symmetric scale per cached row (``k_scales`` / ``v_scales``,
  ``[num_kv_heads, num_pages, page_size]``; the comm stack's
  `quantize_symmetric_q8` format). ``quant="int4"`` packs two values a
  byte into uint8 pools ``[..., head_dim // 2]`` (`nn.quant.pack_q4`:
  high nibble = even lane, offset +8) with the same scale pools
  (max|row| / 7); head_dim must be even. The kernels dequantize as they
  stage the keys.
* ``DenseKVCache``: per layer ``[2, batch, num_heads, max_len,
  head_dim]`` with one shared write position ``pos`` (a device int32
  scalar, set and advanced on the device, as the reference keeps it), the
  aligned-batch cache of `generate(use_cache="dense")`.

Page 0 of every paged pool (scale pools too) is the **trash page**:
writes of padding and inactive-slot tokens land there at ``pos %
page_size``, so every scatter has a fixed shape and no masking branch.
It is never mapped in any page table.

Where the reference threads donated pool buffers through a compiled
step, the writers here update the pools in place (``index_copy_`` on the
``[kvh, num_pages * page_size, d]`` view; the dense cache by slice
assignment).

Host metadata (page tables, seq_lens, active) lives as numpy between
steps, as in the reference; a step hands back device tensors and
`_host` pulls them down again on the next host mutation.
"""
from __future__ import annotations

import numpy as np
import torch

from ..distributed.collective import quantize_symmetric_q8
from ..framework.device import resolve_device
from ..nn.quant import pack_q4, quantize_symmetric_q4

__all__ = ["PagedKVCache", "DenseKVCache", "blob_checksum",
           "paged_write_decode",
           "paged_write_prefill", "paged_write_decode_q8",
           "paged_write_prefill_q8", "paged_write_decode_q4",
           "paged_write_prefill_q4", "dense_write_prefill",
           "dense_write_chunk", "slot_rows",
           "write_rows", "quantize_rows", "write_rows_quant", "write_layer",
           "layer_scales",
           "decode_plan", "prefill_plan"]

_POOL_DTYPES = {"int8": torch.int8, "int4": torch.uint8}


def blob_checksum(blob):
    raise NotImplementedError(
        "blob_checksum is not ported yet: ROADMAP queue A8 (fleet "
        "hand-off)")


# ---------------------------------------------------------------------------
# writers (used inside the serving steps)
# ---------------------------------------------------------------------------

def slot_rows(page_tables, slot_ids):
    """``page_tables[slot_ids]`` with out-of-range ids clamped to the last
    row, as the reference's gather does: the serving engine pads a
    chunk-prefill batch with slot id ``max_slots``, and that dummy row
    must read some row (its writes go to the trash page anyway)."""
    return page_tables[slot_ids.long().clamp(0, page_tables.shape[0] - 1)]


def _page_flat_index(page_tables, pos, page_size):
    """Flat ``[num_pages * page_size)`` pool index of logical position
    ``pos`` per slot (``pos`` [b, t] against table rows [b, pp]).

    A position past the table (a decode slot saturated at the engine
    window, ``max_len % page_size == 0``) goes to the trash page at
    ``pos % page_size``. The reference lands there too, by accident:
    ``take_along_axis`` fills the out-of-range page with INT32_MIN,
    which times a power-of-two page size wraps to 0 in int32."""
    pp = page_tables.shape[1]
    idx = torch.div(pos, page_size, rounding_mode="floor")
    inside = idx < pp
    page = torch.gather(page_tables, 1, idx.clamp(max=pp - 1).long())
    off = pos % page_size
    return torch.where(inside, page * page_size + off, off)


def write_rows(pool, flat, rows):
    """pool [kvh, P, ps, d] <- rows [kvh, n, d] at flat positions [n]
    (long), in place."""
    kvh, num_pages, page_size, d = pool.shape
    pool.view(kvh, num_pages * page_size, d).index_copy_(
        1, flat, rows.to(pool.dtype))


def decode_write_index(page_tables, seq_lens, active, page_size):
    """Flat pool index [b] (long) of each slot's decode token, at its own
    position ``seq_lens[i]``; inactive slots go to the trash page."""
    flat = _page_flat_index(page_tables, seq_lens[:, None].long(),
                            page_size)[:, 0]
    return torch.where(active, flat, seq_lens.long() % page_size)


def prefill_write_index(rows, start, seq_lens_new, s, page_size):
    """Flat pool index [b * s] (long) of a chunk's tokens: token t of row
    i at logical position ``start_i + t`` of the slot whose table row is
    ``rows[i]``; positions at or past ``seq_lens_new[i]`` (right padding)
    go to the trash page. start: [b] or None (0)."""
    t = torch.arange(s, device=rows.device)[None, :]
    pos = t if start is None else start.long()[:, None] + t
    pos = pos.expand(rows.shape[0], s)
    flat = _page_flat_index(rows, pos, page_size)
    valid = pos < seq_lens_new.long()[:, None]
    return torch.where(valid, flat, pos % page_size).reshape(-1)


def paged_write_decode(k_pages, v_pages, page_tables, seq_lens, active,
                       k_new, v_new):
    """One decode token per slot at its own position ``seq_lens[i]``;
    inactive slots write to the trash page. k_new/v_new: [b, kvh, d].
    Updates the pools in place."""
    flat = decode_write_index(page_tables, seq_lens, active,
                              k_pages.shape[2])
    write_rows(k_pages, flat, k_new.movedim(1, 0))
    write_rows(v_pages, flat, v_new.movedim(1, 0))


def paged_write_prefill(k_pages, v_pages, page_tables, slot_ids,
                        seq_lens_new, k_new, v_new, start=None):
    """Token t of row i lands at logical position ``start_i + t`` of slot
    ``slot_ids[i]``; positions at or past ``seq_lens_new[i]`` (right
    padding) go to the trash page. k_new/v_new: [b, s, kvh, d]; start:
    [b] or None (0). Updates the pools in place."""
    kvh, _, page_size, d = k_pages.shape
    b, s = k_new.shape[:2]
    flat = prefill_write_index(slot_rows(page_tables, slot_ids), start,
                               seq_lens_new, s, page_size)
    write_rows(k_pages, flat, k_new.movedim(2, 0).reshape(kvh, b * s, d))
    write_rows(v_pages, flat, v_new.movedim(2, 0).reshape(kvh, b * s, d))


def quantize_rows(rows, quant):
    """(payload, scales) of rows [..., d]: int8, or int4 packed to
    d // 2 bytes; one fp32 scale a row."""
    if quant == "int4":
        q, sc = quantize_symmetric_q4(rows)
        return pack_q4(q), sc
    return quantize_symmetric_q8(rows)


def _write_quantized(pool, scales, flat, q, sc):
    kvh, num_pages, page_size, pd = pool.shape
    pool.view(kvh, num_pages * page_size, pd).index_copy_(1, flat, q)
    scales.view(kvh, num_pages * page_size).index_copy_(1, flat, sc)


def write_rows_quant(pool, scales, flat, rows, quant):
    """Quantize rows [kvh, n, d] one scale a row (int8, or int4 packed to
    d // 2 bytes) and write payload and scale at the same flat positions
    [n] (long) of pool [kvh, P, ps, d or d // 2] and scales [kvh, P, ps],
    in place."""
    _write_quantized(pool, scales, flat, *quantize_rows(rows, quant))


def _write_decode_q(quant, k_pages, v_pages, k_scales, v_scales,
                    page_tables, seq_lens, active, k_new, v_new):
    flat = decode_write_index(page_tables, seq_lens, active,
                              k_pages.shape[2])
    write_rows_quant(k_pages, k_scales, flat, k_new.movedim(1, 0), quant)
    write_rows_quant(v_pages, v_scales, flat, v_new.movedim(1, 0), quant)


def _write_prefill_q(quant, k_pages, v_pages, k_scales, v_scales,
                     page_tables, slot_ids, seq_lens_new, k_new, v_new,
                     start=None):
    b, s, kvh, d = k_new.shape
    flat = prefill_write_index(slot_rows(page_tables, slot_ids), start,
                               seq_lens_new, s, k_pages.shape[2])
    write_rows_quant(k_pages, k_scales, flat,
                     k_new.movedim(2, 0).reshape(kvh, b * s, d), quant)
    write_rows_quant(v_pages, v_scales, flat,
                     v_new.movedim(2, 0).reshape(kvh, b * s, d), quant)


def paged_write_decode_q8(k_pages, v_pages, k_scales, v_scales,
                          page_tables, seq_lens, active, k_new, v_new):
    """`paged_write_decode` for int8 pools: each [d] row quantized, its
    payload and fp32 scale written at the same index, in place."""
    _write_decode_q("int8", k_pages, v_pages, k_scales, v_scales,
                    page_tables, seq_lens, active, k_new, v_new)


def paged_write_prefill_q8(k_pages, v_pages, k_scales, v_scales,
                           page_tables, slot_ids, seq_lens_new, k_new,
                           v_new, start=None):
    """`paged_write_prefill` for int8 pools, in place."""
    _write_prefill_q("int8", k_pages, v_pages, k_scales, v_scales,
                     page_tables, slot_ids, seq_lens_new, k_new, v_new,
                     start)


def paged_write_decode_q4(k_pages, v_pages, k_scales, v_scales,
                          page_tables, seq_lens, active, k_new, v_new):
    """`paged_write_decode` for int4 pools (uint8 ``[..., d // 2]``):
    each row quantized to [-7, 7] and nibble-packed, in place."""
    _write_decode_q("int4", k_pages, v_pages, k_scales, v_scales,
                    page_tables, seq_lens, active, k_new, v_new)


def paged_write_prefill_q4(k_pages, v_pages, k_scales, v_scales,
                           page_tables, slot_ids, seq_lens_new, k_new,
                           v_new, start=None):
    """`paged_write_prefill` for int4 pools, in place."""
    _write_prefill_q("int4", k_pages, v_pages, k_scales, v_scales,
                     page_tables, slot_ids, seq_lens_new, k_new, v_new,
                     start)


def dense_write_prefill(cache_l, k_new, v_new):
    """Prompt K/V at positions [0, s) of one layer's dense cache, in
    place. cache_l: [2, b, nh, max_len, d]; k_new/v_new: [b, s, nh, d]."""
    s = k_new.shape[1]
    cache_l[0, :, :, :s] = k_new.transpose(1, 2)
    cache_l[1, :, :, :s] = v_new.transpose(1, 2)


def dense_write_chunk(cache_l, start, valid_len, k_new, v_new):
    """Multi-token ragged write into one layer's dense cache, in place:
    token t of row i lands at position ``start[i] + t``; positions at or
    past ``valid_len[i]`` (or past max_len) are dropped. The dense face
    of the speculative verify, whose accepted prefix varies by row.

    cache_l: [2, b, nh, max_len, d]; k_new/v_new: [b, t, nh, d];
    start/valid_len: [b] int. A dropped token writes back the value it
    finds at its position modulo max_len, which no kept token of its row
    writes (the window is shorter than the cache), so the scatter has a
    fixed shape and no duplicate index."""
    max_len = cache_l.shape[3]
    b, t = k_new.shape[:2]
    pos = start.long()[:, None] + torch.arange(t, device=k_new.device)[None]
    ok = pos < torch.clamp(valid_len.long()[:, None], max=max_len)
    idx = pos % max_len
    rows = torch.arange(b, device=k_new.device)[:, None].expand(b, t)
    upd = torch.stack([k_new, v_new], dim=2).to(cache_l.dtype)
    old = cache_l[:, rows, :, idx]                         # [b, t, 2, nh, d]
    cache_l[:, rows, :, idx] = torch.where(ok[:, :, None, None, None], upd,
                                           old)


def write_layer(cache, layer_idx, flat, k_rows, v_rows):
    """Write rows [kvh, n, d] of K and V into layer ``layer_idx`` of a
    paged cache at flat positions [n]: as they are into fp pools,
    quantized with their scales into int8/int4 pools. K and V quantize
    in one pass (row by row, so exactly as two would): the serving loop
    is host-bound, and this halves the quantizer's launches."""
    kp, vp = cache.k_layers[layer_idx], cache.v_layers[layer_idx]
    if cache.quantized:
        q, sc = quantize_rows(torch.stack([k_rows, v_rows]), cache.quant)
        _write_quantized(kp, cache.k_scales[layer_idx], flat, q[0], sc[0])
        _write_quantized(vp, cache.v_scales[layer_idx], flat, q[1], sc[1])
    else:
        write_rows(kp, flat, k_rows)
        write_rows(vp, flat, v_rows)


def layer_scales(cache, layer_idx):
    """The attention kernels' ``k_scales``/``v_scales`` of one layer:
    its scale pools when the cache is quantized, else (None, None)."""
    if not cache.quantized:
        return None, None
    return cache.k_scales[layer_idx], cache.v_scales[layer_idx]


def decode_plan(cache):
    """What every layer of one decode step shares: each slot's flat
    write index and its attention length (``seq_lens + 1``, 0 for an
    inactive slot). Computed once a step, not once a layer."""
    write = decode_write_index(cache.page_tables, cache.seq_lens,
                               cache.active, cache.page_size)
    lens = torch.where(cache.active, cache.seq_lens + 1,
                       torch.zeros_like(cache.seq_lens))
    return write, lens


def prefill_plan(cache, slot_ids, start, seq_lens_new, c):
    """What every layer of one chunk-prefill call shares: the flat write
    index of the chunk's tokens and the rows' gathered page tables."""
    rows = slot_rows(cache.page_tables, slot_ids).contiguous()
    write = prefill_write_index(rows, start, seq_lens_new, c,
                                cache.page_size)
    return write, rows


# ---------------------------------------------------------------------------
# the cache: device pools + host bookkeeping
# ---------------------------------------------------------------------------

class DenseKVCache:
    """Aligned-batch dense cache: one shared write position ``pos`` (the
    tokens already cached: a device int32 0-d tensor, which the steps set
    and advance in place and never read back to the host), one column
    write a layer a step."""

    kind = "dense"

    def __init__(self, num_layers, batch, max_len, num_heads, head_dim,
                 dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        self.num_layers = num_layers
        self.batch = batch
        self.max_len = max_len
        self.num_heads = num_heads
        self.head_dim = head_dim
        shape = (2, batch, num_heads, max_len, head_dim)
        self.layers = [torch.zeros(shape, dtype=dtype, device=self.device)
                       for _ in range(num_layers)]
        self.pos = torch.zeros((), dtype=torch.int32, device=self.device)

    def layer(self, l):
        return self.layers[l]

    def state(self):
        return {"layers": list(self.layers), "pos": self.pos}

    def load_state(self, state):
        self.layers = list(state["layers"])
        self.pos = state["pos"]


class PagedKVCache:
    """Paged pools + page tables + ragged lengths + slot bookkeeping.

    Host side: `allocate(prompt_len)` claims a slot and maps enough
    pages; `reserve(slot, total_len)` maps more as decoding grows a
    sequence; `free(slot)` returns its pages to the pool. Only the steps
    change seq_lens and the pools; only the host bookkeeping changes
    page_tables and active.
    """

    kind = "paged"

    def __init__(self, num_layers, num_kv_heads, head_dim, num_pages,
                 page_size, max_slots, pages_per_seq, dtype=torch.float32,
                 quant=None, device=None):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the trash page)")
        if quant not in (None, "int8", "int4"):
            raise ValueError(f"unknown KV quant mode {quant!r}")
        if quant == "int4" and head_dim % 2:
            raise ValueError(
                f"int4 KV packs two values per byte along head_dim: "
                f"head_dim must be even, got {head_dim}")
        self.device = resolve_device(device)
        self.num_layers = num_layers
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_slots = max_slots
        self.pages_per_seq = pages_per_seq
        self.quant = quant
        self.dtype = _POOL_DTYPES.get(quant, dtype)
        # int4 pools hold head_dim values in head_dim // 2 bytes a row
        self.pool_head_dim = head_dim // 2 if quant == "int4" else head_dim
        shape = (num_kv_heads, num_pages, page_size, self.pool_head_dim)
        self.k_layers = [torch.zeros(shape, dtype=self.dtype,
                                     device=self.device)
                         for _ in range(num_layers)]
        self.v_layers = [torch.zeros(shape, dtype=self.dtype,
                                     device=self.device)
                         for _ in range(num_layers)]
        if quant is not None:
            # one fp32 scale a cached row
            sshape = (num_kv_heads, num_pages, page_size)
            self.k_scales = [torch.zeros(sshape, device=self.device)
                             for _ in range(num_layers)]
            self.v_scales = [torch.zeros(sshape, device=self.device)
                             for _ in range(num_layers)]
        self.page_tables = np.zeros((max_slots, pages_per_seq), np.int32)
        self.seq_lens = np.zeros((max_slots,), np.int32)
        self.active = np.zeros((max_slots,), bool)
        # host bookkeeping — page 0 reserved as trash
        self._free_pages = list(range(num_pages - 1, 0, -1))
        self._free_slots = list(range(max_slots - 1, -1, -1))
        self._slot_pages: dict[int, list[int]] = {}

    @property
    def quantized(self):
        return self.quant is not None

    # -- host bookkeeping ------------------------------------------------
    def _host(self, name):
        """Writable host copy of a metadata array (the last step may have
        left a device tensor there)."""
        arr = getattr(self, name)
        if not isinstance(arr, np.ndarray):
            arr = arr.cpu().numpy().copy()
            setattr(self, name, arr)
        return arr

    @property
    def free_page_count(self):
        return len(self._free_pages)

    @property
    def free_slot_count(self):
        return len(self._free_slots)

    def pages_needed(self, total_len: int) -> int:
        """Pages required to hold `total_len` tokens of one sequence."""
        return -(-int(total_len) // self.page_size)   # ceil

    def can_allocate(self, prompt_len: int) -> bool:
        """Admission probe: would `allocate(prompt_len)` succeed? Touches
        no state."""
        need = self.pages_needed(prompt_len)
        return (bool(self._free_slots) and need <= self.pages_per_seq
                and need <= len(self._free_pages))

    def can_reserve(self, slot: int, total_len: int) -> bool:
        """Growth probe: would `reserve(slot, total_len)` succeed?"""
        pages = self._slot_pages.get(slot)
        if pages is None:
            return False
        need = self.pages_needed(total_len)
        return (need <= self.pages_per_seq
                and need - len(pages) <= len(self._free_pages))

    def allocate(self, prompt_len: int) -> int:
        """Claim a slot with pages covering `prompt_len` tokens.

        Atomic: a failed allocation raises before any state is touched."""
        if not self._free_slots:
            raise RuntimeError("no free cache slots (batch full)")
        self._check_reservable(self.pages_needed(prompt_len), 0,
                               prompt_len)
        # lowest free slot, not stack order: a LIFO pop hands slots back
        # permuted after the first reuse, and every step indexes the
        # batch as row i == slot i
        slot = min(self._free_slots)
        self._free_slots.remove(slot)
        self._slot_pages[slot] = []
        self._host("seq_lens")[slot] = 0
        self._host("active")[slot] = True
        self.reserve(slot, prompt_len)
        return slot

    def _check_reservable(self, need, have, total_len):
        if need > self.pages_per_seq:
            raise RuntimeError(
                f"sequence of {total_len} tokens exceeds pages_per_seq="
                f"{self.pages_per_seq} * page_size={self.page_size}")
        if need - have > len(self._free_pages):
            raise RuntimeError("KV page pool exhausted")

    def reserve(self, slot: int, total_len: int):
        """Map pages so slot `slot` can hold `total_len` tokens. Atomic
        like `allocate`."""
        pages = self._slot_pages[slot]
        need = self.pages_needed(total_len)
        self._check_reservable(need, len(pages), total_len)
        pt = self._host("page_tables")
        while len(pages) < need:
            page = self._free_pages.pop()
            pt[slot, len(pages)] = page
            pages.append(page)

    def pool_stats(self) -> dict:
        """Page-pool occupancy snapshot: pure host bookkeeping, no device
        sync. ``fragmentation`` compares the longest contiguous run of
        free page ids with the free count (0.0 = one solid extent).
        Invariant: used + free == total."""
        free = sorted(self._free_pages)
        max_contig = run = 0
        prev = None
        for p in free:
            run = run + 1 if prev is not None and p == prev + 1 else 1
            max_contig = max(max_contig, run)
            prev = p
        used = sum(len(p) for p in self._slot_pages.values())
        total = self.num_pages - 1            # page 0 is trash
        # bytes a cached token takes over all layers, K and V, scale
        # pools counted: int8 pays head_dim + 4, int4 head_dim // 2 + 4
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        per_tok = self.num_layers * 2 * self.num_kv_heads * (
            self.pool_head_dim * itemsize + (4 if self.quantized else 0))
        # the same geometry in bf16 pools: the capacity baseline
        bf16_per_tok = self.num_layers * 2 * self.num_kv_heads \
            * self.head_dim * 2
        return {
            "kv_dtype": self.quant or str(self.dtype).replace("torch.", ""),
            "bytes_per_token": per_tok,
            "effective_slots_vs_bf16": round(bf16_per_tok / per_tok, 4),
            "page_bytes": per_tok * self.page_size,
            "pool_bytes": per_tok * self.page_size * self.num_pages,
            "total_pages": total,
            "free_pages": len(free),
            "used_pages": used,
            "trash_pages": 1,
            "page_size": self.page_size,
            "slot_pages": {int(s): len(p)
                           for s, p in sorted(self._slot_pages.items())},
            "max_contiguous_free": max_contig,
            "fragmentation": (round(1.0 - max_contig / len(free), 4)
                              if free else 0.0),
            "occupancy": round(used / total, 4) if total else 0.0,
        }

    def set_active(self, slot: int, flag: bool):
        """Host toggle for decode participation: a slot stays inactive
        while its prompt is still chunk-prefilling."""
        self._host("active")[slot] = bool(flag)

    def free(self, slot: int):
        """Return the slot's pages to the pool (continuous batching)."""
        pages = self._slot_pages.pop(slot, [])
        self._free_pages.extend(reversed(pages))
        self._free_slots.append(slot)
        self._host("page_tables")[slot] = 0
        self._host("seq_lens")[slot] = 0
        self._host("active")[slot] = False

    # -- slot migration: the fleet slice ---------------------------------
    def export_slot(self, slot):
        raise NotImplementedError(
            "PagedKVCache.export_slot is not ported yet: ROADMAP queue A8 "
            "(fleet hand-off)")

    def import_slot(self, blob, active=False):
        raise NotImplementedError(
            "PagedKVCache.import_slot is not ported yet: ROADMAP queue A8 "
            "(fleet hand-off)")

    # -- device state ------------------------------------------------------
    def state(self):
        out = {"k_layers": list(self.k_layers),
               "v_layers": list(self.v_layers),
               "page_tables": self.page_tables,
               "seq_lens": self.seq_lens, "active": self.active}
        if self.quantized:
            out["k_scales"] = list(self.k_scales)
            out["v_scales"] = list(self.v_scales)
        return out

    def load_state(self, state):
        self.k_layers = list(state["k_layers"])
        self.v_layers = list(state["v_layers"])
        self.page_tables = state["page_tables"]
        self.seq_lens = state["seq_lens"]
        self.active = state["active"]
        if self.quantized:
            self.k_scales = list(state["k_scales"])
            self.v_scales = list(state["v_scales"])
