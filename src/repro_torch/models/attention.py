"""GQA self-attention of the port: monolithic prefill, one-token decode
against a dense (B, Hkv, S, Dh) cache or a windowed ring buffer, and the
paged serving paths (one-token decode, one prefill chunk); cross-attention
over a context (whisper's encoder output, llama-3.2-vision's image
embeddings) with its K/V cached for decode.

Port of ``repro.models.attention``. On a mesh attention runs inside its
block's map (``core.distributed.block_map``) on each rank's batch and head
shard, as the reference constrains q, k and v: the projections, RoPE,
``ops.attention`` and the row-parallel out projection on plain local
tensors, so the kernels (flash_attention and its backward, flash_decode, the
paged kernels) see plain tensors, and one sum over "model". Serving on a
mesh (``serve_rules``: kv_heads replicated, the dense cache split along S
over "model") runs the reference's kv_seq-sharded decode
(``_decode_attention_seq_sharded``): q's heads gathered over "model", the
new K/V written by the rank whose slice holds the slot, the rank's slice
attended by flash_decode at its local position with the log-sum-exp out,
and the ranks' partials merged exactly (``LocalMesh.merge_lse``). Page pools
are whole on every rank: each rank writes every row's K/V and attends its
rows with q's heads gathered. A dense cache is written IN PLACE
at slot ``pos``, a ring buffer at slot ``pos % S``. Page pools are
(num_pages, Hkv, page_size, Dh) per layer, or with a ``kv_spec``
(serving.engine.kvquant.PagedQuantSpec) {"q": intN page bytes, "scale": one
f32 per (page, head)} for each of k and v. Where the reference returns new
pools (JAX donates the old buffers), the port writes the pools IN PLACE with
``index_put_`` / ``index_copy_`` and returns the same tensors.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.kernels import ops

from .layers import NULL_SHARDER, ParamSpec, Sharder, apply_rope


# ---------------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------------
def attn_specs(cfg) -> Dict[str, ParamSpec]:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    s = {
        "wq": ParamSpec((d, h, dh), dt, logical_axes=("embed", "heads", None)),
        "wk": ParamSpec((d, hkv, dh), dt, logical_axes=("embed", "kv_heads", None)),
        "wv": ParamSpec((d, hkv, dh), dt, logical_axes=("embed", "kv_heads", None)),
        "wo": ParamSpec((h, dh, d), dt, logical_axes=("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((h, dh), torch.float32, "zeros", logical_axes=("heads", None))
        s["bk"] = ParamSpec((hkv, dh), torch.float32, "zeros", logical_axes=("kv_heads", None))
        s["bv"] = ParamSpec((hkv, dh), torch.float32, "zeros", logical_axes=("kv_heads", None))
    return s


def cross_attn_specs(cfg) -> Dict[str, ParamSpec]:
    """The same projection geometry as self-attention; k / v project the
    context."""
    return attn_specs(cfg)


def cache_specs(cfg, batch: int, seq: int) -> Dict[str, ParamSpec]:
    """One layer's dense decode cache, (B, Hkv, S, Dh) for each of k and v."""
    shape = (batch, cfg.n_kv_heads, seq, cfg.head_dim)
    axes = ("batch", "kv_heads", "kv_seq", None)
    return {"k": ParamSpec(shape, cfg.param_dtype, "zeros", logical_axes=axes),
            "v": ParamSpec(shape, cfg.param_dtype, "zeros", logical_axes=axes)}


def paged_cache_specs(cfg, num_pages: int, page_size: int, kv_spec=None):
    """One layer's page pool: page-major, (page_size, head_dim) innermost.
    ``kv_spec`` swaps the element representation without touching the layout:
    k and v each become {"q": intN page bytes, "scale": f32 per (page, head)}."""
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    if kv_spec is not None:
        def quant():
            return {
                "q": ParamSpec((num_pages, hkv, page_size, kv_spec.packed_dim(dh)), torch.int8,
                               "zeros", logical_axes=(None, "kv_heads", None, None)),
                "scale": ParamSpec((num_pages, hkv), torch.float32, "zeros",
                                   logical_axes=(None, "kv_heads")),
            }
        return {"k": quant(), "v": quant()}
    shape = (num_pages, hkv, page_size, dh)
    axes = (None, "kv_heads", None, None)
    return {
        "k": ParamSpec(shape, cfg.param_dtype, "zeros", logical_axes=axes),
        "v": ParamSpec(shape, cfg.param_dtype, "zeros", logical_axes=axes),
    }


def pack_kv_pages(pool: Dict[str, torch.Tensor], k: torch.Tensor, v: torch.Tensor,
                  pages: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Scatter freshly prefilled K/V into pool pages, in place.

    pool k/v: (L, num_pages, Hkv, ps, Dh); k/v: (L, 1, Hkv, S, Dh) with S a
    multiple of ps; pages: (n,) physical ids of the sequence's logical pages
    0..n-1, n == S // ps."""
    l, _, hkv, s, dh = k.shape
    ps = pool["k"].shape[3]
    n = s // ps
    idx = pages.to(device=pool["k"].device, dtype=torch.long)
    for name, x in (("k", k), ("v", v)):
        xp = x[:, 0].reshape(l, hkv, n, ps, dh).transpose(1, 2)  # (L, n, Hkv, ps, Dh)
        pool[name].index_copy_(1, idx, xp.to(pool[name].dtype))
    return pool


def pack_kv_pages_quant(pool, k: torch.Tensor, v: torch.Tensor, pages: torch.Tensor, *,
                        spec) -> Dict[str, Dict[str, torch.Tensor]]:
    """pack_kv_pages for a quantized pool, in place: each page is encoded
    with a fresh scale per (page, head) (spec.encode_pages), bytes and scales
    written together. pool k/v: {"q": (L, num_pages, Hkv, ps, Dq), "scale":
    (L, num_pages, Hkv)}; k/v and pages as in pack_kv_pages. The zero pad of
    a partial page takes part in its scale, so a page stays a pure function of
    the tokens that hash to it."""
    l, _, hkv, s, dh = k.shape
    ps = pool["k"]["q"].shape[3]
    n = s // ps
    idx = pages.to(device=pool["k"]["q"].device, dtype=torch.long)
    for name, x in (("k", k), ("v", v)):
        enc = spec.encode_pages(x[:, 0].reshape(l, hkv, n, ps, dh).transpose(1, 2))
        for part in ("q", "scale"):
            pool[name][part].index_copy_(1, idx, enc[part])
    return pool


def pack_kv_cache(cfg, k: torch.Tensor, v: torch.Tensor, *, max_len: Optional[int],
                  window: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Prefilled K/V (B, Hkv, S, Dh) laid out as the decode cache, in the param
    dtype. Without a window: padded along S to ``max_len`` (token p at slot
    p). With one: a ring of ``window`` slots where token p lives at slot p %
    window — the last ``window`` tokens rolled by S % window when S >= window,
    else padded to ``window`` (not to ``max_len``), as the reference does."""
    s = k.shape[2]
    if window is not None and s >= window:
        k = torch.roll(k[:, :, -window:], s % window, dims=2)
        v = torch.roll(v[:, :, -window:], s % window, dims=2)
    else:
        cap = window if window is not None else (max_len if max_len is not None else s)
        if cap > s:
            pad = (0, 0, 0, cap - s)
            k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    return {"k": k.to(cfg.param_dtype), "v": v.to(cfg.param_dtype)}


# ---------------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------------
def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("btd,dhk->bhtk", x, w) as one matmul."""
    b, t, d = x.shape
    _, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).reshape(b, t, h, k).transpose(1, 2)


def _project_qkv(cfg, p, x: torch.Tensor):
    """(B, H, T, Dh) x 3 from x (B, T, D), biases added when the config has them."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)[None, :, None, :]
        k = k + p["bk"].to(x.dtype)[None, :, None, :]
        v = v + p["bv"].to(x.dtype)[None, :, None, :]
    return q, k, v


def _out_proj(p, attn_out: torch.Tensor, x_dtype) -> torch.Tensor:
    """einsum("bhtk,hkd->btd", attn_out, wo) as one matmul."""
    b, h, t, k = attn_out.shape
    wo = p["wo"].to(x_dtype)
    return attn_out.transpose(1, 2).reshape(b, t, h * k) @ wo.reshape(h * k, wo.shape[-1])


# ---------------------------------------------------------------------------------
# self-attention paths
# ---------------------------------------------------------------------------------
def _local_kv_heads(cfg, hq_loc: int, hkv_loc: int, lm):
    """The heads of the local k / v that serve this rank's q heads: a slice
    when they are a run, each kv head repeated for an equal share of the q
    heads (a head-sharded k, or one kv head for a few q heads), else the kv
    head of each q head in turn. Where the rules replicate k over "model"
    and shard q (kv_heads not dividing the model axis: the Megatron
    fallback), a rank holds every kv head but serves only its q heads'
    groups. Off a mesh (``lm`` None), every kv head."""
    group = cfg.n_heads // cfg.n_kv_heads
    rank = lm.model_rank if lm is not None else 0
    q_off = rank * hq_loc if hq_loc < cfg.n_heads else 0
    k_off = rank * hkv_loc if hkv_loc < cfg.n_kv_heads else 0
    need = [(q_off + i) // group - k_off for i in range(hq_loc)]
    if min(need) < 0 or max(need) >= hkv_loc:
        raise ValueError(f"q heads {q_off}..{q_off + hq_loc - 1} need kv heads outside "
                         f"the local {k_off}..{k_off + hkv_loc - 1}")
    first, n = need[0], len(set(need))
    if hq_loc % n == 0 and need == [first + i // (hq_loc // n) for i in range(hq_loc)]:
        return slice(first, first + n)
    return torch.tensor(need)


def attn_partial(p, prefix: str = "") -> set:
    """The leaves (paths under ``prefix``) of DTensor attention weights
    ``p`` whose gradient each rank holds only a part of on "model": k's and
    v's where q is split over "model" and they are not (the Megatron
    fallback: a rank's gradient covers its q heads' groups)."""
    from repro_torch.core.distributed import is_split

    if is_split(p["wq"], 1) and not is_split(p["wk"], 1):
        return {prefix + k for k in ("wk", "wv", "bk", "bv") if k in p}
    return set()


def _serve_heads(cfg, q: torch.Tensor, k: torch.Tensor, lm):
    """Serving on a mesh: (q on the heads the attention runs, the slice of
    its output heads that are this rank's, or None). Where q is split over
    "model" and k / v hold every kv head (``serve_rules`` replicate
    kv_heads), q's heads are gathered, as the reference replicates q for its
    sharded decode, so the kernels see whole caches or pools and every head
    of q; where k / v are split alike (kv_heads dividing the model axis
    under other rules) each rank's q heads meet their own kv heads."""
    if lm is None or lm.model is None or q.shape[1] == cfg.n_heads:
        return q, None
    if k.shape[1] < cfg.n_kv_heads:
        _local_kv_heads(cfg, q.shape[1], k.shape[1], lm)  # refuses a selection across ranks
        return q, None
    n = q.shape[1]
    return lm.gather(q.contiguous(), 1), slice(lm.model_rank * n, (lm.model_rank + 1) * n)


def _own_heads(out: torch.Tensor, heads) -> torch.Tensor:
    return out if heads is None else out[:, heads]


def _rows(lm, t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a whole-batch tensor (the block map's token
    shard: ``LocalMesh.token_rank_and_count``); the tensor itself off a
    mesh or where the batch is not split."""
    if lm is None or not lm.tokens:
        return t
    rank, count = lm.token_rank_and_count()
    n = t.shape[0] // count
    return t[rank * n:(rank + 1) * n]


def _all_rows(lm, t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``t`` (the batch's shards gathered): what a
    rank writes into its copy of the whole page pools."""
    if lm is None or not lm.tokens:
        return t
    return lm.gather_tokens(t.contiguous(), 0)


def _mapped(body, shard, x, p, extras=()):
    """An attention layer alone in one block map (its own entry on a mesh:
    the blocks map their whole bodies, ``models.transformer``)."""
    from repro_torch.core.distributed import block_map

    return block_map(body, shard.mesh, x, p, extras, partial=attn_partial(p))


def self_attention(cfg, p, x: torch.Tensor, *, shard: Sharder = NULL_SHARDER, lm=None,
                   causal: bool = True, window: Optional[int] = None, pos_offset: int = 0,
                   return_kv: bool = False, impl: str = "auto"):
    """Full-sequence self-attention (forward / monolithic prefill). x: (B, T,
    D); ``impl`` picks ops.attention's kernel (flash_attention) or its plain
    version.

    Inside a block map (``lm``, a ``core.distributed.LocalMesh``) x and the
    weights are this rank's shards: with the heads split over "model", q, k
    and v on the rank's heads (its q heads' kv heads where the rules
    replicate k and v: ``_local_kv_heads``), the kernel, then the
    row-parallel out projection and one sum over "model". ``return_kv``
    then returns the rank's k and v as the rules lay them out (every kv head
    where kv_heads is replicated: the prefill's cache rows). On DTensors
    (``shard`` active) the layer runs alone in one block map, its k and v
    coming out as DTensors laid out as x on the batch and as wk on the
    heads."""
    if shard.active(x):
        kv = []

        def body(lm_, x_, p_):
            y = self_attention(cfg, p_, x_, lm=lm_, causal=causal, window=window,
                               pos_offset=pos_offset, return_kv=return_kv, impl=impl)
            if not return_kv:
                return y
            kv.append(y[1])
            return y[0]

        y = _mapped(body, shard, x, p)
        if not return_kv:
            return y
        return y, tuple(_kv_dtensor(t, x, p["wk"]) for t in kv[0])
    split = lm is not None and lm.model is not None and p["wq"].shape[1] < cfg.n_heads
    if split:
        x = lm.enter(x)
    t = x.shape[1]
    q, k, v = _project_qkv(cfg, p, x)
    pos = torch.arange(t, device=x.device) + pos_offset
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    v = v.contiguous()
    kv = (k, v)
    if lm is not None:
        sel = _local_kv_heads(cfg, q.shape[1], k.shape[1], lm)
        k, v = k[:, sel].contiguous(), v[:, sel].contiguous()
    out = ops.attention(q, k, v, causal=causal, window=window, q_offset=pos_offset, impl=impl)
    y = _out_proj(p, out, x.dtype)
    if split:
        y = lm.sum(y)
    if return_kv:
        return y, kv
    return y


def _kv_dtensor(local: torch.Tensor, x, wk):
    """A block map's local k or v (B_loc, Hkv_loc, T, Dh) as a DTensor:
    sharded on the batch as x (B, T, D) is, on the heads as wk (D, Hkv, Dh)
    is, replicated elsewhere."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    pl = [Shard(0) if xp == Shard(0) else Shard(1) if wp == Shard(1) else Replicate()
          for xp, wp in zip(x.placements, wk.placements)]
    return DTensor.from_local(local.contiguous(), x.device_mesh, pl, run_check=False)


class DecodePos(NamedTuple):
    """A decode position held both ways: ``host`` (an int) and ``dev`` (the
    same as a one-element int32 tensor on the device). A caller that decodes
    many layers at one host position makes the tensor once and passes this;
    each layer checks its own capacity against the int."""
    host: int
    dev: torch.Tensor


def self_attention_decode(cfg, p, x: torch.Tensor, cache: Dict[str, torch.Tensor], pos, *,
                          window: Optional[int] = None, impl: str = "auto", lm=None,
                          seq_split: bool = False):
    """One-token decode against one layer's dense cache or ring buffer.

    x: (B, 1, D); cache k/v: (B, Hkv, S, Dh); ``pos`` (an int, a one-element
    integer tensor on x's device, or a DecodePos of both) is the current
    token's position.

    Without a window (pos < S) its K/V is written IN PLACE at slot ``pos``,
    then ops.decode_attention attends slots <= pos. A host ``pos`` (an int or
    a DecodePos) at or past the capacity S raises ValueError (the reference
    would write slot pos % S and silently lose the oldest token); a tensor
    ``pos`` alone is not read on the host, so no step waits for it.

    With a window the cache is a ring of S <= window slots (token p at slot
    p % S, pack_kv_cache's layout): the K/V is written at slot pos % S, on the
    device. The reference then attends with an eager masked einsum, slot i
    live when its absolute position pos - ((pos % S - i) mod S) lies in
    [max(pos - window + 1, 0), pos]. A slot that holds a token holds one of
    the last S <= window positions, all inside the window, so that live set
    is exactly "slot i <= min(pos, S - 1)": every slot once the ring has
    wrapped, the written prefix before. Softmax does not depend on the order
    of the slots, so ops.decode_attention at position min(pos, S - 1), with
    no window, computes the reference's function: the flash_decode kernel
    runs unchanged and nothing waits on the host.

    Inside a serving block map (``lm``) q is on the rank's heads; with
    ``seq_split`` the cache is this rank's slice of S_total = S * model
    slots, [r * S, (r + 1) * S), the reference's ``_decode_attention_seq_sharded``
    (which it takes without a window; the ring's live set above makes the
    same step exact on a split ring, as GSPMD computes it there): q's
    heads gathered, the K/V written on the device at local slot (pos or pos
    % S_total) - r * S only where that lies in the slice, flash_decode over
    the slice at local position min(pos, S_total - 1) - r * S with its
    log-sum-exp (negative: no live key, lse -inf; past the slice: every slot
    live), the exact merge over "model", the rank's heads kept for the
    row-parallel out projection and its sum. Without ``seq_split`` every
    rank holds the whole cache (S not dividing the model axis) and attends
    with q's heads gathered alike."""
    s_len = cache["k"].shape[2]
    s_total = s_len * lm.model_size if seq_split else s_len
    if isinstance(pos, DecodePos):
        host, posv = pos.host, pos.dev.reshape(1)
    elif isinstance(pos, torch.Tensor):
        host, posv = None, pos.reshape(1)
    else:
        host = int(pos)
        posv = torch.full((1,), host, dtype=torch.int32, device=x.device)
    if window is None and host is not None and host >= s_total:
        raise ValueError(f"decode at position {host} past the dense cache's capacity of "
                         f"{s_total} tokens (make the cache with a larger max_len)")
    split = lm is not None and lm.model is not None and p["wq"].shape[1] < cfg.n_heads
    if split:
        x = lm.enter(x)
    q, k, v = _project_qkv(cfg, p, x)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    slot = posv if window is None else posv % s_total
    last = posv if window is None else torch.clamp(posv, max=s_total - 1)
    q, heads = _serve_heads(cfg, q, k, lm)
    if seq_split:
        off = lm.model_rank * s_len
        loc = slot - off
        live = (loc >= 0) & (loc < s_len)
        idx = loc.clamp(0, s_len - 1).long()
        for name, t in (("k", k), ("v", v)):
            c = cache[name]
            c.index_copy_(2, idx, torch.where(live, t.to(c.dtype), c.index_select(2, idx)))
        out, lse = ops.decode_attention(q.contiguous(), cache["k"], cache["v"], last,
                                        key_offset=off, return_lse=True, impl=impl)
        out = lm.merge_lse(out, lse)
    else:
        idx = slot.long()
        cache["k"].index_copy_(2, idx, k.to(cache["k"].dtype))
        cache["v"].index_copy_(2, idx, v.to(cache["v"].dtype))
        out = ops.decode_attention(q.contiguous(), cache["k"], cache["v"], last, impl=impl)
    y = _out_proj(p, _own_heads(out, heads), x.dtype)
    return (lm.sum(y) if split else y), cache


def _page_size(cache, kv_spec) -> int:
    return (cache["k"]["q"] if kv_spec is not None else cache["k"]).shape[2]


def _quant_append(buf: Dict[str, torch.Tensor], tok: torch.Tensor, page: torch.Tensor,
                  slot: torch.Tensor, spec) -> None:
    """Scatter one quantized token per batch row into its (page, slot), in
    place. buf: {"q": (num_pages, Hkv, ps, Dq), "scale": (num_pages, Hkv)};
    tok: (B, Hkv, Dh). Slot 0 means the page is brand new, so it takes a fresh
    per-head scale from the token; any other slot re-quantizes with the
    page's existing scale, clipped (read before it is written). Inactive rows
    all target the null page 0, where their bytes and scales land harmlessly."""
    fresh = (slot == 0)[:, None]
    scale = torch.where(fresh, spec.token_scale(tok), buf["scale"][page])
    buf["q"][page, :, slot, :] = spec.quantize_tokens(tok, scale)
    buf["scale"][page] = scale


def self_attention_decode_paged(cfg, p, x: torch.Tensor, cache, block_tables: torch.Tensor,
                                context_lens: torch.Tensor, kv_spec=None, block_pages=None,
                                lm=None):
    """One-token decode against one layer's page pool.

    x: (B, 1, D); cache k/v: (num_pages, Hkv, ps, Dh), or with ``kv_spec``
    {"q", "scale"} quantized pools; block_tables (B, max_pages) int32;
    context_lens (B,) int32 tokens already cached. The new token's K/V is
    written IN PLACE at position context_lens[b] (page block_tables[b, len //
    ps], slot len % ps), quantized at scatter time over a quantized pool,
    then attention covers positions < len + 1. ``block_pages`` is the tuned
    decode block-shape knob, forwarded verbatim to
    ops.paged_decode_attention{,_quant} (None = unblocked).

    Inside a serving block map (``lm``) x is the rank's rows and q its
    heads, the tables and lengths whole: the rank's copy of the whole pools
    takes every row's K/V (the batch's shards gathered), then its rows
    attend with q's heads gathered (``_serve_heads``), the row-parallel out
    projection summed over "model"."""
    ps = _page_size(cache, kv_spec)
    split = lm is not None and lm.model is not None and p["wq"].shape[1] < cfg.n_heads
    if split:
        x = lm.enter(x)
    q, k, v = _project_qkv(cfg, p, x)
    pos_all = context_lens.to(torch.int32)
    pos = _rows(lm, pos_all)
    tables = _rows(lm, block_tables)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = _all_rows(lm, apply_rope(k, pos[:, None], cfg.rope_theta))
    v = _all_rows(lm, v)
    rows = torch.arange(block_tables.shape[0], device=x.device)
    page = block_tables[rows, (pos_all // ps).long()].long()
    slot = (pos_all % ps).long()
    q, heads = _serve_heads(cfg, q, k, lm)
    if kv_spec is not None:
        _quant_append(cache["k"], k[:, :, 0, :], page, slot, kv_spec)
        _quant_append(cache["v"], v[:, :, 0, :], page, slot, kv_spec)
        ck, cv = cache["k"], cache["v"]
        out = ops.paged_decode_attention_quant(
            q.contiguous(), ck["q"], ck["scale"], cv["q"], cv["scale"], tables, pos + 1,
            bits=kv_spec.bits, block_pages=block_pages,
        )
    else:
        cache["k"][page, :, slot, :] = k[:, :, 0, :].to(cache["k"].dtype)
        cache["v"][page, :, slot, :] = v[:, :, 0, :].to(cache["v"].dtype)
        out = ops.paged_decode_attention(
            q.contiguous(), cache["k"], cache["v"], tables, pos + 1,
            block_pages=block_pages,
        )
    y = _out_proj(p, _own_heads(out, heads), x.dtype)
    return (lm.sum(y) if split else y), cache


def self_attention_verify_paged(cfg, p, x: torch.Tensor, cache, block_tables: torch.Tensor,
                                context_lens: torch.Tensor, kv_spec=None, lm=None):
    """Speculative verify: C = K + 1 tokens a row scored in one chunk call.

    x: (B, C, D), the embeddings of [current token, draft_1 .. draft_K];
    context_lens (B,) tokens already resident, any alignment. Token j's K/V
    is appended in place at position lens + j by the decode path's
    one-token law, in a loop over j: over an intN pool the page-scale
    lifecycle (_quant_append: a fresh scale at slot 0, the page's own
    otherwise) is order-dependent within a page. The present is then
    gathered back from the pool (dequantized under ``kv_spec``) and cast to
    q's dtype, so each draft row attends the bytes a one-token decode would
    read, and one chunk-attention call with cursors = context_lens scores
    all C rows against the past and the causal present. Rejected positions
    need no undo: they lie past the rolled-back lens and later appends
    overwrite them. Inactive rows (nulled table and lens) write the null
    page. Inside a serving block map (``lm``) every row's K/V is appended
    to the rank's whole pools and the rank's rows are scored with q's heads
    gathered, as in ``self_attention_decode_paged``."""
    c = x.shape[1]
    ps = _page_size(cache, kv_spec)
    split = lm is not None and lm.model is not None and p["wq"].shape[1] < cfg.n_heads
    if split:
        x = lm.enter(x)
    q, k, v = _project_qkv(cfg, p, x)  # (B, H, C, Dh)
    lens_all = context_lens.to(torch.int32)
    ar = torch.arange(c, device=x.device, dtype=torch.int32)[None, :]
    pos_all = lens_all[:, None] + ar
    lens, block_tables_all, block_tables = _rows(lm, lens_all), block_tables, _rows(lm, block_tables)
    pos = lens[:, None] + ar
    q = apply_rope(q, pos, cfg.rope_theta).contiguous()
    k = _all_rows(lm, apply_rope(k, pos, cfg.rope_theta))
    v = _all_rows(lm, v)
    rows = torch.arange(block_tables_all.shape[0], device=x.device)
    pages, slots = [], []
    for j in range(c):
        pj = pos_all[:, j]
        page = block_tables_all[rows, (pj // ps).long()].long()
        slot = (pj % ps).long()
        pages.append(page)
        slots.append(slot)
        if kv_spec is not None:
            _quant_append(cache["k"], k[:, :, j, :], page, slot, kv_spec)
            _quant_append(cache["v"], v[:, :, j, :], page, slot, kv_spec)
        else:
            cache["k"][page, :, slot, :] = k[:, :, j, :].to(cache["k"].dtype)
            cache["v"][page, :, slot, :] = v[:, :, j, :].to(cache["v"].dtype)
    pg = _rows(lm, torch.stack(pages, dim=1))  # (B, C): the rank's rows
    sl = _rows(lm, torch.stack(slots, dim=1))
    q, heads = _serve_heads(cfg, q, k, lm)
    ck, cv = cache["k"], cache["v"]
    if kv_spec is not None:
        k_pres = kv_spec.decode_pages(ck["q"][pg, :, sl, :][:, :, :, None, :],
                                      ck["scale"][pg])[..., 0, :]  # (B, C, Hkv, Dh)
        v_pres = kv_spec.decode_pages(cv["q"][pg, :, sl, :][:, :, :, None, :],
                                      cv["scale"][pg])[..., 0, :]
    else:
        k_pres, v_pres = ck[pg, :, sl, :], cv[pg, :, sl, :]
    k_pres = k_pres.transpose(1, 2).to(q.dtype).contiguous()  # (B, Hkv, C, Dh)
    v_pres = v_pres.transpose(1, 2).to(q.dtype).contiguous()
    if kv_spec is not None:
        out = ops.paged_prefill_chunk_attention_quant(
            q, k_pres, v_pres, ck["q"], ck["scale"], cv["q"], cv["scale"], block_tables, lens,
            bits=kv_spec.bits,
        )
    else:
        out = ops.paged_prefill_chunk_attention(q, k_pres, v_pres, ck, cv, block_tables, lens)
    y = _out_proj(p, _own_heads(out, heads), x.dtype)
    return (lm.sum(y) if split else y), cache


def _scatter_chunk_pages(cache, kp: torch.Tensor, vp: torch.Tensor, dest: torch.Tensor,
                         kv_spec=None) -> None:
    """Scatter whole chunk pages into the pool in place. kp/vp: (B, nP, Hkv,
    ps, Dh) page-factored chunk K/V; dest: (B, nP) physical destinations
    (invalid entries already routed to the null page 0, bytes and scales
    alike). A quantized pool encodes each page with a fresh scale per (page,
    head), pack_kv_pages_quant's law, so a chunk-written page equals a
    monolithic-prefill one and the prefix index may share across the two."""
    b, npg = dest.shape
    hkv, ps, dh = kp.shape[2:]
    flat = dest.reshape(-1).long()
    for name, x in (("k", kp), ("v", vp)):
        x = x.reshape(b * npg, hkv, ps, dh)
        if kv_spec is not None:
            enc = kv_spec.encode_pages(x)
            for part in ("q", "scale"):
                cache[name][part].index_copy_(0, flat, enc[part])
        else:
            cache[name].index_copy_(0, flat, x.to(cache[name].dtype))


def self_attention_prefill_chunk_paged(cfg, p, x: torch.Tensor, cache,
                                       block_tables: torch.Tensor,
                                       write_tables: torch.Tensor, cursors: torch.Tensor,
                                       n_new: torch.Tensor, kv_spec=None, lm=None):
    """One prefill CHUNK against one layer's page pool.

    x: (B, C, D), C a page multiple; block_tables: the READ view (every
    resident page, shared ones included); write_tables: the WRITE view, with
    adopted shared pages and unallocated entries nulled to page 0; cursors
    (B,) page-aligned tokens resident before the chunk; n_new (B,) valid new
    tokens (pages past it route to the null page). The chunk's K/V is
    scattered IN PLACE into its pages, then its queries attend the past (pool
    positions < cursor) and the chunk's own K/V (causal), which stays in the
    compute dtype over a quantized pool (``kv_spec``). Inside a serving
    block map (``lm``) every row's chunk is scattered into the rank's whole
    pools and the rank's rows attend with q's heads gathered, as in
    ``self_attention_decode_paged``."""
    c = x.shape[1]
    ps = _page_size(cache, kv_spec)
    npg = c // ps
    max_pages = block_tables.shape[1]
    split = lm is not None and lm.model is not None and p["wq"].shape[1] < cfg.n_heads
    if split:
        x = lm.enter(x)
    q, k, v = _project_qkv(cfg, p, x)
    ar_c = torch.arange(c, device=x.device)
    cur = _rows(lm, cursors)
    pos = cur[:, None] + ar_c[None, :]  # (B, C)
    q = apply_rope(q, pos, cfg.rope_theta).contiguous()
    k = apply_rope(k, pos, cfg.rope_theta).contiguous()
    v = v.contiguous()
    k_all, v_all = _all_rows(lm, k), _all_rows(lm, v)
    b, hkv, _, dh = k_all.shape
    kp = k_all.reshape(b, hkv, npg, ps, dh).transpose(1, 2)  # (B, nP, Hkv, ps, Dh)
    vp = v_all.reshape(b, hkv, npg, ps, dh).transpose(1, 2)
    ar_p = torch.arange(npg, device=x.device)
    logical = (cursors[:, None] // ps + ar_p[None, :]).clamp(0, max_pages - 1).long()
    gathered = torch.gather(write_tables, 1, logical)
    valid = ar_p[None, :] * ps < n_new[:, None]
    dest = torch.where(valid, gathered, torch.zeros_like(gathered))
    _scatter_chunk_pages(cache, kp, vp, dest, kv_spec)
    tables = _rows(lm, block_tables)
    q, heads = _serve_heads(cfg, q, k, lm)
    if kv_spec is not None:
        ck, cv = cache["k"], cache["v"]
        out = ops.paged_prefill_chunk_attention_quant(
            q, k, v, ck["q"], ck["scale"], cv["q"], cv["scale"], tables, cur,
            bits=kv_spec.bits,
        )
    else:
        out = ops.paged_prefill_chunk_attention(
            q, k, v, cache["k"], cache["v"], tables, cur
        )
    y = _out_proj(p, _own_heads(out, heads), x.dtype)
    return (lm.sum(y) if split else y), cache


# ---------------------------------------------------------------------------------
# cross-attention paths (whisper decoder, vlm image layers)
# ---------------------------------------------------------------------------------
def cross_attention(cfg, p, x: torch.Tensor, ctx: torch.Tensor, *,
                    shard: Sharder = NULL_SHARDER, lm=None, return_kv: bool = False,
                    impl: str = "auto"):
    """x (B, T, D) queries against ctx (B, Tc, D) keys / values: no RoPE on
    either, non-causal ops.attention (flash_attention on CUDA). A ctx in
    another dtype than x is cast to x's (the reference's einsum would
    promote instead). With ``return_kv`` also (k, v) (B, Hkv, Tc, Dh) for the
    decode cache. Inside a block map (``lm``) with the heads split over
    "model", q from x and k, v from ctx on the rank's heads, both entering
    the split branch (their gradients summed over "model"), then the
    row-parallel out projection and one sum (``return_kv``: the rank's k and
    v as the rules lay them out, every kv head under ``serve_rules``); on
    DTensors (``shard`` active) the layer runs alone in one block map, ctx
    an input of it."""
    if shard.active(x):
        kv = []

        def body(lm_, x_, p_, c_):
            y = cross_attention(cfg, p_, x_, c_, lm=lm_, return_kv=return_kv, impl=impl)
            if not return_kv:
                return y
            kv.append(y[1])
            return y[0]

        y = _mapped(body, shard, x, p, (ctx,))
        if not return_kv:
            return y
        return y, tuple(_kv_dtensor(t, x, p["wk"]) for t in kv[0])
    split = lm is not None and lm.model is not None and p["wq"].shape[1] < cfg.n_heads
    ctx = ctx.to(x.dtype)
    if split:
        x, ctx = lm.enter(x), lm.enter(ctx)
    q = _proj(x, p["wq"])
    k, v = _proj(ctx, p["wk"]), _proj(ctx, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)[None, :, None, :]
        k = k + p["bk"].to(x.dtype)[None, :, None, :]
        v = v + p["bv"].to(x.dtype)[None, :, None, :]
    k, v = k.contiguous(), v.contiguous()
    kv = (k, v)
    if lm is not None:
        sel = _local_kv_heads(cfg, q.shape[1], k.shape[1], lm)
        k, v = k[:, sel].contiguous(), v[:, sel].contiguous()
    out = ops.attention(q.contiguous(), k, v, causal=False, impl=impl)
    y = _out_proj(p, out, x.dtype)
    if split:
        y = lm.sum(y)
    if return_kv:
        return y, kv
    return y


def cross_attention_decode(cfg, p, x: torch.Tensor, kv, impl: str = "auto", lm=None,
                           seq_split: bool = False):
    """One query row a sequence, x (B, 1, D), against the cached context K/V
    (B, Hkv, Tc, Dh), cast to x's dtype. The reference runs non-causal
    attention at Tq = 1; every slot of the cache is live, so that is the
    dense decode at position Tc - 1, and ops.decode_attention runs it on
    flash_decode's split-K body (flash_attention would give each head one
    64-row block with one live row, walking all Tc keys in series).

    Inside a serving block map (``lm``) q is on the rank's heads, gathered
    (``_serve_heads``); with ``seq_split`` the context's K/V is the rank's
    slice of Tc_total = Tc * model keys, attended at local position
    Tc_total - 1 - r * Tc (every slot live) with its log-sum-exp and merged
    over "model", as the sharded self-attention decode."""
    split = lm is not None and lm.model is not None and p["wq"].shape[1] < cfg.n_heads
    if split:
        x = lm.enter(x)
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)[None, :, None, :]
    k, v = kv
    q, heads = _serve_heads(cfg, q, k, lm)
    q, k, v = q.contiguous(), k.to(x.dtype), v.to(x.dtype)
    if seq_split:
        t_loc = k.shape[2]
        off = lm.model_rank * t_loc
        out, lse = ops.decode_attention(q, k, v, t_loc * lm.model_size - 1, key_offset=off,
                                        return_lse=True, impl=impl)
        out = lm.merge_lse(out, lse)
    else:
        out = ops.decode_attention(q, k, v, k.shape[2] - 1, impl=impl)
    y = _out_proj(p, _own_heads(out, heads), x.dtype)
    return lm.sum(y) if split else y
