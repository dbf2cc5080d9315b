"""Climber — the GR model FLAME serves (paper §2.1, Fig 2).  Port of
``repro/core/climber.py``: the scoring, extension and generation paths and
the training loss (``loss_fn`` on the bundle, run by ``training/loop.py``).

Architecture: the user history is reorganized into ``N_b`` sub-sequences,
each processed by an independent transformer block; every attention divides
q by a learned adaptive temperature; the M candidates sit after each block's
sub-sequence under the SUMI mask; per-candidate block outputs are fused with
bit-wise gating and scored by a multi-task (MMoE) head.

Parameters are a nested dict with the JAX package's names and layouts
(layer-stacked ``[L, ...]`` block weights), so :func:`params_from_jax` can
load the JAX ``climber_init`` values one to one.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional

import torch

from repro_torch import sharding as shd
from repro_torch.core import sumi
from repro_torch.devices import resolve_device
from repro_torch.kernels.fused_score.ref import dequantize_values
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.ffn import ffn_apply, ffn_init
from repro_torch.tree import params_from_jax, params_to  # noqa: F401
from repro_torch.tree import unstack
from repro_torch.types import ModelConfig, ShapeConfig, TensorSpec

N_SIDE_FEATURES = 12   # "a dozen pieces of side information" (paper §4.1)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _block_init(cfg, n_layers: int, *, generator, device):
    return {
        "norm1": L.norm_init(cfg, cfg.d_model, device=device,
                             stacked=n_layers),
        "attn": A.qkv_init(cfg, generator=generator, device=device,
                           stacked=n_layers),
        "norm2": L.norm_init(cfg, cfg.d_model, device=device,
                             stacked=n_layers),
        "ffn": ffn_init(cfg, generator=generator, device=device,
                        stacked=n_layers),
        # adaptive temperature, one per layer: tau = softplus(t) + 0.5
        "temp": L.full_init((1,), (None,), 0.55, device=device, dtype=torch.float32,
                            stacked=n_layers),
    }


def climber_init(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                 device="cuda") -> Dict:
    """Random Climber parameters (bf16, float32 temperatures) on ``device``
    from ``generator`` (default: seed 0 on that device).  Raises when
    ``device="cuda"`` and no GPU is present."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    c = cfg.climber
    d = cfg.d_model
    kw = dict(generator=generator, device=dev)
    blocks = {f"b{i}": _block_init(cfg, c.layers_per_block, **kw)
              for i in range(c.num_blocks)}
    return {
        "embed": {"embedding": L.dense_init((cfg.vocab_size, d),
                                            ("vocab", "embed"), scale=0.02,
                                            **kw)},
        "pos_embed": L.dense_init((8192, d), (None, "embed"), scale=0.02,
                                  **kw),
        "side_proj": L.dense_init((N_SIDE_FEATURES, d), (None, "embed"),
                                  **kw),
        "blocks": blocks,
        "gate_w": L.dense_init((c.num_blocks, d), (None, "embed"),
                               scale=0.02, **kw),
        "gate_b": L.full_init((c.num_blocks, d), (None, "embed"), 0.0,
                              device=dev),
        "out_norm": L.norm_init(cfg, d, device=dev),
        "experts_w1": L.dense_init((c.num_experts_head, d, d),
                                   (None, "embed", "mlp"),
                                   fan_in_axes=(1,), **kw),
        "experts_w2": L.dense_init((c.num_experts_head, d, d),
                                   (None, "mlp", "embed"),
                                   fan_in_axes=(1,), **kw),
        "task_gates": L.dense_init((c.num_tasks, d, c.num_experts_head),
                                   (None, "embed", None),
                                   fan_in_axes=(1,), **kw),
        "task_towers": L.dense_init((c.num_tasks, d), (None, "embed"),
                                    fan_in_axes=(1,), **kw),
    }


def _tau(p):
    """Adaptive temperature of one layer: softplus(t) + 0.5, with softplus
    written as ``jax.nn.softplus`` computes it (max(x, 0) + log1p(exp(-|x|)))."""
    t = p["temp"][0]
    return torch.clamp_min(t, 0.0) + torch.log1p(torch.exp(-t.abs())) + 0.5


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------

def _history_block_inputs(params, batch: Dict, cfg) -> list:
    """Embed the history and reorganize it into per-block input sequences:
    [sub-sequence + positional embeddings, context side token] — the side
    token rides at the END of each block's history prefix."""
    hist = _embed(params, batch["history"], cfg)
    b, n, d = hist.shape
    side = torch.matmul(batch["side"].to(hist.dtype),
                        params["side_proj"])[:, None]
    nb = cfg.climber.num_blocks
    w = n // nb
    sub = hist.reshape(b, nb, w, d)
    return [torch.cat([sub[:, i] + params["pos_embed"][None, :w], side], dim=1)
            for i in range(nb)]


def _embed(params, ids, cfg):
    """Item embeddings; the table's rows may be the rank's ``vocab``
    block of a mesh (``sharding.embed_lookup``)."""
    return shd.embed_lookup(params["embed"]["embedding"], ids,
                            cfg.vocab_size)


def _fuse_and_head(params, h, cfg):
    """Per-candidate block outputs h [B,M,Nb,d] -> task logits [B,M,T].
    Under a mesh the MMoE experts' hidden axis (``mlp``) may be split
    over ``model``: their second product is then summed over it."""
    hf = h.float()
    gate_logits = hf * params["gate_w"].float() + params["gate_b"].float()
    gates = torch.softmax(gate_logits, dim=2)
    fused = (gates * hf).sum(dim=2)                          # [B,M,d]
    fused = L.apply_norm(cfg, params["out_norm"], fused)
    e1 = torch.einsum("bmd,edh->bmeh", fused, params["experts_w1"].float())
    e1 = L.gelu(e1)
    e2 = torch.einsum("bmeh,ehg->bmeg", e1, params["experts_w2"].float())
    if params["experts_w2"].shape[1] != cfg.d_model:
        e2 = shd.model_sum(e2, e2.dtype)
    tg = torch.softmax(torch.einsum("bmd,tde->bmte", fused,
                                    params["task_gates"].float()), dim=-1)
    mix = torch.einsum("bmte,bmeg->bmtg", tg, e2)
    return torch.einsum("bmtg,tg->bmt", mix, params["task_towers"].float())


def _layer_tail(p, x, o, cfg, impl: str):
    """Out-projection + residual + norm + FFN + residual.  Under
    ``impl="pallas"`` the FFN is kernel K3 (``models/ffn.py``); the JAX
    fused ``block_epilogue`` takes its kernel only for rmsnorm models, so
    for Climber every other impl is this same plain composition.  Under
    tensor parallelism the rank holds its heads' rows of the
    out-projection and its ``mlp`` rows of the down projection: each
    product is then the rank's partial sum (in float32 where it is a
    matmul, so that the sum over ``model`` rounds once, as one rank's
    product does), summed before its residual."""
    split = p["attn"]["wo"].shape[0] != cfg.n_heads
    out = A.project_out(p["attn"], o, partial=split)
    x = x + (shd.model_sum(out, x.dtype) if split else out)
    h2 = L.apply_norm(cfg, p["norm2"], x)
    split = p["ffn"]["w_down"].shape[0] != cfg.d_ff
    out = ffn_apply(p["ffn"], h2, cfg, impl=impl, partial=split)
    return x + (shd.model_sum(out, x.dtype) if split else out)


def _block_forward(bp, x, n_history: int, cfg, impl: str):
    """x [B,S,d] through one block under the SUMI mask; every candidate sits
    at RoPE position ``n_history``."""
    b, s, _ = x.shape
    pos = torch.cat([torch.arange(n_history, device=x.device),
                     torch.full((s - n_history,), n_history,
                                device=x.device)])
    positions = pos.expand(b, s)
    for p in unstack(bp):
        h = L.apply_norm(cfg, p["norm1"], x)
        q, k, v = A.project_qkv(p["attn"], h, cfg, positions)
        o = sumi.sumi_attention(q, k, v, n_history, impl=impl,
                                temperature=_tau(p))
        x = _layer_tail(p, x, o, cfg, impl)
    return x


def _block_encode_kv(bp, x, cfg, impl: str):
    """History-only causal pass over one block; per-layer K/V stacked on
    axis 1: k, v [B,L,s,Hkv,D]."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    ks, vs = [], []
    for p in unstack(bp):
        h = L.apply_norm(cfg, p["norm1"], x)
        q, k, v = A.project_qkv(p["attn"], h, cfg, positions)
        # n_history == s: the SUMI mask degenerates to causal here
        o = sumi.sumi_attention(q, k, v, s, impl=impl, temperature=_tau(p))
        x = _layer_tail(p, x, o, cfg, impl)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks, dim=1), torch.stack(vs, dim=1)


def _block_score(bp, cand, k_hist, v_hist, cfg, impl: str, *, k_scale=None,
                 v_scale=None, row_index=None):
    """Candidate-only pass for one block against cached history K/V:
    ``cand`` [B,M,d]; ``k_hist``/``v_hist`` [L,U,n_hist,Hkv,D] (stored
    precision), scales [L,U,1,Hkv,1] or None, ``row_index`` [B] or None.
    Candidates all sit at RoPE position ``n_hist``."""
    b, m, _ = cand.shape
    n_hist = k_hist.shape[2]
    positions = torch.full((b, m), n_hist, device=cand.device)
    x = cand
    for i, p in enumerate(unstack(bp)):
        h = L.apply_norm(cfg, p["norm1"], x)
        q, k, v = A.project_qkv(p["attn"], h, cfg, positions)
        o = sumi.cached_candidate_attention(
            q, k_hist[i], v_hist[i], k, v, impl=impl, temperature=_tau(p),
            k_scale=None if k_scale is None else k_scale[i],
            v_scale=None if v_scale is None else v_scale[i],
            row_index=row_index)
        x = _layer_tail(p, x, o, cfg, impl)
    return x


def encode_history(params, batch: Dict, cfg: ModelConfig, *,
                   impl: str = "reference"):
    """batch: history [B,n] ids, side [B,F] -> HistoryKV: per block
    ``b{i}`` {"k", "v"} of shape [B, L, n // num_blocks + 1, Hkv, D]."""
    kv = {}
    for i, xb in enumerate(_history_block_inputs(params, batch, cfg)):
        k, v = _block_encode_kv(params["blocks"][f"b{i}"], xb, cfg, impl)
        kv[f"b{i}"] = {"k": k, "v": v}
    return kv


def _block_extend_kv(bp, x_suf, k_pref, v_pref, cfg, impl: str):
    """Suffix-only causal pass for one block against cached prefix K/V.

    ``x_suf`` [B,S_suf,d] holds the block inputs from position ``P`` on
    (changed history items + the side token); ``k_pref``/``v_pref``
    [B,L,P,Hkv,D] are the trusted rows of a cached encode.  Returns the
    per-layer K/V of the suffix positions, [B,L,S_suf,Hkv,D] — what a full
    :func:`_block_encode_kv` gives for those rows (reference impl), because
    causal attention at position >= P sees exactly ``concat(prefix,
    suffix)``.  ``S_suf`` and ``P`` are shapes, so the pass captures."""
    b, s_suf, _ = x_suf.shape
    p0 = k_pref.shape[2]
    positions = (p0 + torch.arange(s_suf, device=x_suf.device)).expand(
        b, s_suf)
    x = x_suf
    ks, vs = [], []
    for i, p in enumerate(unstack(bp)):
        h = L.apply_norm(cfg, p["norm1"], x)
        q, k, v = A.project_qkv(p["attn"], h, cfg, positions)
        o = sumi.extend_attention(q, k_pref[:, i], v_pref[:, i], k, v,
                                  impl=impl, temperature=_tau(p))
        x = _layer_tail(p, x, o, cfg, impl)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks, dim=1), torch.stack(vs, dim=1)


def _dequant_stored_entry(entry, dtype):
    """A pool entry leaf is a plain tensor or a raw ``(values, scale)``
    view in the pool's stored precision (``scale is None`` marks a bf16
    cast).  Dequantized here, inside the executor, by the pool's own
    formula (``serving/kv_cache.py::dequantize_leaf``), so a raw basis
    extends bitwise like the host-dequantized one."""
    if isinstance(entry, tuple):
        values, scale = entry
        return dequantize_values(values, scale, dtype)
    return entry


def extend_history(params, history_kv, batch: Dict, cfg: ModelConfig, *,
                   prefix_len: int, impl: str = "reference"):
    """Incremental suffix extension of a cached HistoryKV (PDA v2).

    Trusts the first ``prefix_len`` positions of the model's history window
    to be unchanged since ``history_kv`` was encoded and re-encodes only
    the rest: per block, the history items at window positions >=
    ``prefix_len`` plus the side token (which always re-encodes: side
    features average the full upstream history).  ``prefix_len == n`` is
    the dominant serving case, a tail-append past the model window, which
    re-encodes one token per block instead of ``n / N_b + 1``.

    Returns a full HistoryKV (cached prefix rows + fresh suffix rows),
    equal to ``encode_history(params, batch)`` under the reference impl
    whenever the trust assumption holds.  ``history_kv`` leaves may be raw
    ``(values, scale)`` pool views, dequantized here."""
    n = batch["history"].shape[1]
    nb = cfg.climber.num_blocks
    w = n // nb
    if not 0 <= prefix_len <= n:
        raise ValueError(f"prefix_len must be in [0, {n}], got {prefix_len}")
    kv = {}
    for i, xb in enumerate(_history_block_inputs(params, batch, cfg)):
        p_i = min(max(prefix_len - i * w, 0), w)
        old = history_kv[f"b{i}"]
        k_all = _dequant_stored_entry(old["k"], xb.dtype)
        v_all = _dequant_stored_entry(old["v"], xb.dtype)
        k_new, v_new = _block_extend_kv(
            params["blocks"][f"b{i}"], xb[:, p_i:], k_all[:, :, :p_i],
            v_all[:, :, :p_i], cfg, impl)
        kv[f"b{i}"] = {"k": torch.cat([k_all[:, :, :p_i], k_new], dim=2),
                       "v": torch.cat([v_all[:, :, :p_i], v_new], dim=2)}
    return kv


def _split_stored(entry):
    """A HistoryKV leaf is a plain [B,L,S,Hkv,D] tensor or a raw ``(values,
    scale)`` pool view; returns (values, scale-or-None) in [L,B,...] layout
    (views, no copies)."""
    values, scale = entry if isinstance(entry, tuple) else (entry, None)
    values = values.movedim(1, 0)
    if scale is not None:
        scale = scale.movedim(1, 0)
    return values, scale


def score_candidates(params, history_kv, candidates, cfg: ModelConfig, *,
                     impl: str = "reference", row_index=None):
    """Candidate-only forward against cached history K/V.  ``candidates``
    [B,M] ids; ``history_kv`` from :func:`encode_history`, as tensors or raw
    pool views (``(values, scale)`` tuples in the pool's stored precision),
    with an optional 1-D ``row_index`` [B] mapping batch rows onto unique
    pool rows.  Returns task logits [B,M,T]."""
    cand = _embed(params, candidates, cfg)
    block_outs = []
    for i in range(cfg.climber.num_blocks):
        kv = history_kv[f"b{i}"]
        kh, khs = _split_stored(kv["k"])
        vh, vhs = _split_stored(kv["v"])
        block_outs.append(_block_score(
            params["blocks"][f"b{i}"], cand, kh, vh, cfg, impl,
            k_scale=khs, v_scale=vhs, row_index=row_index))
    return _fuse_and_head(params, torch.stack(block_outs, dim=2), cfg)


def _block_decode(bp, cand, k_hist, v_hist, lengths, cfg, impl: str, *,
                  k_scale=None, v_scale=None, row_index=None,
                  collect_kv: bool = False):
    """Generative-decode pass for one block against a PADDED beam cache:
    like :func:`_block_score`, but the cached history's valid prefix per
    pool row is ``lengths`` [U] and each candidate sits at RoPE position
    ``lengths`` of its own row — the next slot of its sequence (a [B, M]
    ``row_index`` packs the beams of several requests in a row).  With
    ``collect_kv`` the per-layer candidate K/V come back too, stacked on
    axis 1 ([B,L,M,Hkv,D]): the append path's token K/V are exactly what
    this pass computed for it."""
    b, m, _ = cand.shape
    lengths = lengths.to(torch.int32)
    if row_index is not None and row_index.dim() == 2:
        positions = lengths[row_index.long()]     # packed: per candidate
    else:
        pos = lengths if row_index is None else lengths[row_index.long()]
        positions = pos[:, None].expand(b, m)
    x = cand
    ks, vs = [], []
    for i, p in enumerate(unstack(bp)):
        h = L.apply_norm(cfg, p["norm1"], x)
        q, k, v = A.project_qkv(p["attn"], h, cfg, positions)
        o = sumi.decode_candidate_attention(
            q, k_hist[i], v_hist[i], k, v, lengths, impl=impl,
            temperature=_tau(p),
            k_scale=None if k_scale is None else k_scale[i],
            v_scale=None if v_scale is None else v_scale[i],
            row_index=row_index)
        x = _layer_tail(p, x, o, cfg, impl)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    if not collect_kv:
        return x, None
    return x, (torch.stack(ks, dim=1), torch.stack(vs, dim=1))


def decode_logits(params, history_kv, candidates, lengths, cfg: ModelConfig,
                  *, impl: str = "reference", row_index=None):
    """One generative-decode scoring step: task logits [B,M,T] for M
    next-token candidates against padded beam caches.  ``history_kv``
    leaves are [U,L,S_pad,Hkv,D] tensors or raw ``(values, scale)`` pool
    views with valid prefix ``lengths`` [U] per row, and an optional 1-D
    ``row_index`` [B] mapping batch rows onto them.  At ``lengths ==
    S_pad`` (no padding) this is :func:`score_candidates` — bitwise under
    the reference impl."""
    cand = _embed(params, candidates, cfg)
    block_outs = []
    for i in range(cfg.climber.num_blocks):
        kv = history_kv[f"b{i}"]
        kh, khs = _split_stored(kv["k"])
        vh, vhs = _split_stored(kv["v"])
        x, _ = _block_decode(params["blocks"][f"b{i}"], cand, kh, vh,
                             lengths, cfg, impl, k_scale=khs, v_scale=vhs,
                             row_index=row_index)
        block_outs.append(x)
    return _fuse_and_head(params, torch.stack(block_outs, dim=2), cfg)


def _write_token(entry, new, lengths):
    """A copy of one padded cache leaf with ``new`` [B,L,1,Hkv,D] written at
    sequence position ``lengths[b]`` of row b.  A raw ``(int8 values,
    scale)`` view quantizes the token against the entry's FIXED absmax
    scale [B,L,1,Hkv,1] (the stored rows keep their codes; only the new
    slot rounds, and clips if it exceeds the row's absmax), as the JAX
    ``append_token`` does in-graph; a bf16 view casts."""
    values, scale = entry if isinstance(entry, tuple) else (entry, None)
    if scale is not None:
        new = torch.clamp(torch.round(new.float() / scale * 127.0), -127, 127)
    out = values.clone()
    rows = torch.arange(out.shape[0], device=out.device)
    out[rows, :, lengths.long()] = new[:, :, 0].to(out.dtype)
    return (out, scale) if isinstance(entry, tuple) else out


def append_token(params, history_kv, tokens, lengths, cfg: ModelConfig, *,
                 impl: str = "reference"):
    """Write one chosen token's per-layer K/V into every block's padded beam
    cache at position ``lengths`` [B] (the beam's next free slot; ``lengths
    < S_pad`` is the caller's contract).  ``tokens`` [B,1] ids;
    ``history_kv`` leaves are tensors or raw pool views, returned in the
    same form (raw views stay in the pool's stored precision).  The written
    K/V come from the same decode-pass layer chain that scored the token,
    so an incrementally grown cache is the cache a monolithic re-encode of
    history + tokens would produce (reference impl)."""
    tok = _embed(params, tokens, cfg)                             # [B,1,d]
    lengths = lengths.to(torch.int32)
    new_kv = {}
    for i in range(cfg.climber.num_blocks):
        kv = history_kv[f"b{i}"]
        kh, khs = _split_stored(kv["k"])
        vh, vhs = _split_stored(kv["v"])
        _, (k_new, v_new) = _block_decode(
            params["blocks"][f"b{i}"], tok, kh, vh, lengths, cfg, impl,
            k_scale=khs, v_scale=vhs, collect_kv=True)
        new_kv[f"b{i}"] = {"k": _write_token(kv["k"], k_new, lengths),
                           "v": _write_token(kv["v"], v_new, lengths)}
    return new_kv


def climber_forward(params, batch: Dict, cfg: ModelConfig, *,
                    impl: str = "reference"):
    """The monolithic SUMI pass (the oracle of the split serving path).
    batch: history [B,n], candidates [B,M], side [B,F] -> logits [B,M,T].
    Under a mesh whose rules shard the d_model axes (FSDP), the tree's
    FSDP axes are gathered first (``sharding.fsdp_gather``)."""
    if shd.active() is not None:
        lg, sh = param_specs(cfg)
        params = shd.fsdp_gather(params, lg, sh)
    cand = _embed(params, batch["candidates"], cfg)
    block_outs = []
    for i, xb in enumerate(_history_block_inputs(params, batch, cfg)):
        seq, n_hist = sumi.assemble(xb, cand)
        out = _block_forward(params["blocks"][f"b{i}"], seq, n_hist, cfg,
                             impl)
        block_outs.append(sumi.split_candidates(out, n_hist))
    return _fuse_and_head(params, torch.stack(block_outs, dim=2), cfg)


@functools.lru_cache(maxsize=None)
def param_specs(cfg: ModelConfig):
    """(logical names, global ``meta`` shapes) of ``cfg``'s parameters."""
    with L.logical_params():
        lg = climber_init(cfg, device="cpu")
    with L.abstract_params():
        sh = climber_init(cfg, device="cpu")
    return lg, sh


def history_kv_specs(params, cfg: ModelConfig, n_history: int,
                     batch: int = 1):
    """Shape/dtype pytree of the HistoryKV :func:`encode_history` returns."""
    c = cfg.climber
    dtype = params["embed"]["embedding"].dtype
    shape = (batch, c.layers_per_block, n_history // c.num_blocks + 1,
             cfg.n_kv_heads, cfg.head_dim)
    return {f"b{i}": {"k": TensorSpec(shape, dtype),
                      "v": TensorSpec(shape, dtype)}
            for i in range(c.num_blocks)}


# ---------------------------------------------------------------------------
# serving surface
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ClimberBundle:
    """One Climber configuration (the port's counterpart of the JAX
    ``ModelBundle`` for this model): ``init`` and the training loss
    ``loss_fn``; the serving surface, ``prefill ==
    score_candidates(encode_history)`` in probabilities, the stale-entry
    refresh ``extend_history``, and the generative pair ``decode_logits`` /
    ``append_token``."""

    cfg: ModelConfig
    init: Callable          # (generator=None, device="cuda") -> params
    loss_fn: Callable       # (params, batch, impl) -> (loss, metrics)
    prefill: Callable
    encode_history: Callable
    score_candidates: Callable
    history_kv_specs: Callable
    decode_logits: Callable
    append_token: Callable
    extend_history: Callable
    input_specs: Callable    # (ShapeConfig) -> {name: meta tensor}
    input_logical: Callable  # (ShapeConfig) -> {name: logical tuple}


def build_climber(cfg: ModelConfig) -> ClimberBundle:
    def init(generator: Optional[torch.Generator] = None, device="cuda"):
        return climber_init(cfg, generator, device)

    def loss_fn(params, batch, impl: str = "reference"):
        """Mean binary cross-entropy with logits over every (user,
        candidate, task) of ``batch`` (history, candidates, side, labels
        [B,M,T]), in the stable form the JAX package writes.  Returns
        (loss, {"bce_loss": loss}), 0-d f32 tensors."""
        logits = climber_forward(params, batch, cfg, impl=impl)
        labels = batch["labels"].float()
        ls = torch.mean(torch.clamp_min(logits, 0) - logits * labels
                        + torch.log1p(torch.exp(-logits.abs())))
        return ls, {"bce_loss": ls}

    def prefill(params, batch, impl: str = "reference"):
        return torch.sigmoid(climber_forward(params, batch, cfg, impl=impl))

    def encode_history_fn(params, batch, impl: str = "reference"):
        return encode_history(params, batch, cfg, impl=impl)

    def score_candidates_fn(params, history_kv, candidates,
                            impl: str = "reference", row_index=None):
        return torch.sigmoid(score_candidates(
            params, history_kv, candidates, cfg, impl=impl,
            row_index=row_index))

    def history_kv_specs_fn(params, n_history: int, batch: int = 1):
        return history_kv_specs(params, cfg, n_history, batch)

    def extend_history_fn(params, history_kv, batch, *, prefix_len: int,
                          impl: str = "reference"):
        """Suffix-only re-encode of a cached HistoryKV whose first
        ``prefix_len`` window positions are unchanged."""
        return extend_history(params, history_kv, batch, cfg,
                              prefix_len=prefix_len, impl=impl)

    def decode_logits_fn(params, history_kv, candidates, lengths,
                         impl: str = "reference", row_index=None):
        """One generative-decode step -> per-candidate probabilities
        [B,M,T] (the sigmoid of score_candidates_fn, so a decode step at
        full length is a score_candidates call)."""
        return torch.sigmoid(decode_logits(
            params, history_kv, candidates, lengths, cfg, impl=impl,
            row_index=row_index))

    def append_token_fn(params, history_kv, tokens, lengths,
                        impl: str = "reference"):
        """Grow every block's padded beam cache by the chosen token's K/V
        at position ``lengths``."""
        return append_token(params, history_kv, tokens, lengths, cfg,
                            impl=impl)

    def input_specs(shape: ShapeConfig):
        """The batch of ``shape`` as ``meta`` tensors (the JAX
        ``ShapeDtypeStruct``s): history, candidates, side, and the labels
        of a train shape."""
        b, n, m = shape.global_batch, shape.seq_len, shape.n_candidates
        meta = dict(device="meta")
        specs = {
            "history": torch.empty((b, n), dtype=torch.int32, **meta),
            "candidates": torch.empty((b, m), dtype=torch.int32, **meta),
            "side": torch.empty((b, N_SIDE_FEATURES), dtype=torch.float32,
                                **meta)}
        if shape.kind == "train":
            specs["labels"] = torch.empty((b, m, cfg.climber.num_tasks),
                                          dtype=torch.float32, **meta)
        return specs

    def input_logical(shape: ShapeConfig):
        lg = {"history": ("batch", None), "candidates": ("batch", None),
              "side": ("batch", None)}
        if shape.kind == "train":
            lg["labels"] = ("batch", None, None)
        return lg

    return ClimberBundle(cfg, init, loss_fn, prefill, encode_history_fn,
                         score_candidates_fn,
                         history_kv_specs_fn, decode_logits_fn,
                         append_token_fn, extend_history_fn, input_specs,
                         input_logical)
