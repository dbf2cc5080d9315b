"""Roofline analysis of one step of the port.  Port of
``repro/roofline.py``, with the H100 as the card (``types.H100``).

Three terms per (arch x shape x mesh), in seconds (lower bound per step):

    compute    = FLOPs             / (chips * peak FLOP/s)
    memory     = bytes accessed    / (chips * HBM bandwidth)
    collective = collective bytes  / (chips * link bandwidth)

The JAX package reads FLOPs and bytes from XLA's ``cost_analysis()`` of the
compiled step and collective bytes from its post-partitioning HLO text.  The
port counts the same two figures by running the step once under two
dispatch modes (:func:`cost_analysis`): FLOPs from
``torch.utils.flop_counter.FlopCounterMode`` (matrix products, convolutions
and attention, as XLA's ``flops`` counts the dots), bytes as the operand and
result bytes of every aten op — the unfused upper bound that XLA:CPU's
``bytes accessed`` is, since no op shares a read with another; view ops and
queries of metadata move nothing and are not counted.  The same mode sums
the result bytes of the c10d collectives it sees, by kind, all-reduce
counted twice as in JAX (a ring all-reduce is a reduce-scatter and an
all-gather); on one card it reads 0.  A step that runs a backward pass
counts it too (FLOPs and bytes of the autograd ops).  By default the step
runs on fake tensors (``FakeTensorMode``), so full width costs no device
memory; a step that reads a value on the host cannot run there and is
counted on real tensors instead (``fake=False``), by its caller at a
reduced depth and scaled by layer.

Count the kernel-free ``reference`` route, which computes each function
once: a plain twin repeats a kernel's arithmetic step by step, and the
hand kernels run outside PyTorch's dispatcher, where nothing counts them.

``model_flops`` (6 N D for training, 2 N D for inference, N the active
parameters) is the useful-compute yardstick; FLOPs over it expose masked or
recomputed work.  ``analytic_hbm_bytes`` is the fusion-aware estimate of
what must cross HBM, which ``dominant`` prefers to the unfused bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.types import H100, HardwareSpec, ModelConfig, ShapeConfig

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# aten / c10d op names -> the JAX package's collective kinds
_COLLECTIVE_NAMES = (("reduce_scatter", "reduce-scatter"),
                     ("all_reduce", "all-reduce"),
                     ("allreduce", "all-reduce"),
                     ("all_gather", "all-gather"),
                     ("allgather", "all-gather"),
                     ("all_to_all", "all-to-all"),
                     ("alltoall", "all-to-all"),
                     ("send", "collective-permute"),
                     ("recv", "collective-permute"))


def _tensor_bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def _collective_kind(func) -> Optional[str]:
    name = str(func)
    if "c10d" not in name:
        return None
    for key, kind in _COLLECTIVE_NAMES:
        if key in name:
            return kind
    return None


class OpBytes(TorchDispatchMode):
    """Sums the operand and result bytes of every aten op that makes a
    tensor and is not a view, and the result bytes of every c10d collective
    by kind."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.collective = {k: 0.0 for k in _COLLECTIVES}
        self.counts = {k: 0 for k in _COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = _collective_kind(func)
        if kind is not None:
            b = _tensor_bytes(out)
            self.collective[kind] += 2 * b if kind == "all-reduce" else b
            self.counts[kind] += 1
        elif func.namespace == "aten" and not getattr(func, "is_view", False):
            out_bytes = _tensor_bytes(out)
            if out_bytes:        # queries of metadata move nothing
                self.bytes += _tensor_bytes((args, kwargs)) + out_bytes
                self.ops += 1
        return out

    def collectives(self) -> Dict[str, object]:
        """The collective bytes in ``collective_bytes_from_hlo``'s form."""
        out: Dict[str, object] = dict(self.collective)
        out["total"] = sum(self.collective[k] for k in _COLLECTIVES)
        out["counts"] = dict(self.counts)
        return out


def cost_analysis(fn, *args, fake: bool = True, **kwargs) -> Dict[str, object]:
    """``fn(*args, **kwargs)`` run once under the counting modes: returns
    ``{"flops", "bytes accessed", "ops", "collectives"}`` (``collectives``
    in :func:`OpBytes.collectives`' form).  With ``fake`` the tensors of
    ``args`` / ``kwargs`` become fake tensors of the same shapes, dtypes and
    devices, and tensors ``fn`` closes over (its weights) are taken as fake
    on the fly, so nothing is computed or allocated; a step that reads a
    value on the host raises there and is counted with ``fake=False`` on
    real tensors."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = OpBytes()
    flops = FlopCounterMode(display=False)
    if fake:
        from torch._subclasses.fake_tensor import FakeTensorMode
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        args, kwargs = tree_map(
            lambda t: mode.from_tensor(t) if isinstance(t, torch.Tensor)
            else t, (args, kwargs))
        with mode, flops, counter:
            fn(*args, **kwargs)
    else:
        with flops, counter:
            fn(*args, **kwargs)
    return {"flops": float(flops.get_total_flops()),
            "bytes accessed": float(counter.bytes), "ops": counter.ops,
            "collectives": counter.collectives()}


def collective_bytes(cost: Dict[str, object]) -> Dict[str, object]:
    """The collective bytes of a :func:`cost_analysis` result, in the form
    of the JAX package's ``collective_bytes_from_hlo`` (per kind, ``total``
    and ``counts``); zeros where none ran."""
    got = cost.get("collectives") if cost else None
    if got:
        return dict(got)
    out: Dict[str, object] = {k: 0.0 for k in _COLLECTIVES}
    out["total"] = 0.0
    out["counts"] = {k: 0 for k in _COLLECTIVES}
    return out


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # whole-job FLOPs (all cards)
    hlo_bytes: float            # whole-job bytes accessed (unfused)
    collective_bytes: float     # whole-job bytes through the links
    model_flops: float          # analytic useful FLOPs
    compute_s: float
    memory_s: float                    # from bytes accessed (unfused UB)
    collective_s: float
    memory_s_est: float = 0.0          # fusion-aware analytic HBM estimate
    per_device_peak_memory: Optional[float] = None
    collective_detail: Optional[dict] = None

    @property
    def dominant(self) -> str:
        """Bottleneck using the fusion-aware memory estimate (the counted
        bytes are an unfused upper bound)."""
        terms = {"compute": self.compute_s,
                 "memory": self.memory_s_est or self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["dominant"] = self.dominant
        d["useful_ratio"] = self.useful_ratio
        return d


def analytic_hbm_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Fusion-aware whole-job HBM-traffic estimate: parameter reads (per
    pass), activation writes + reads at layer granularity, optimizer state
    traffic, KV-cache traffic, logits (the JAX package's arithmetic)."""
    p_total = cfg.param_count()
    p_active = cfg.active_param_count()
    d, f, v, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    bpe = 2  # bf16
    if shape.kind == "decode":
        toks = shape.global_batch
        # weights read once; KV cache read fully per token; tiny writes
        cache_len = shape.seq_len
        win = cfg.sliding_window or shape.seq_len
        cache = 0.0
        for kind in cfg.layer_pattern:
            if kind == "attn":
                cache += cfg.n_groups * 2 * cfg.n_kv_heads * cfg.head_dim * \
                    cache_len * bpe
            elif kind == "swa":
                cache += cfg.n_groups * 2 * cfg.n_kv_heads * cfg.head_dim * \
                    min(win, cache_len) * bpe
        cache *= shape.global_batch
        return p_active * bpe + cache + toks * v * bpe
    toks = shape.seq_len * shape.global_batch
    if shape.n_candidates:
        toks = (shape.seq_len + shape.n_candidates) * shape.global_batch
    act_per_layer = toks * (8 * d + 2 * f) * bpe   # w+r at layer granularity
    logits = toks * v * (bpe + 4)
    if shape.kind == "prefill":
        return p_active * bpe + L * act_per_layer + logits
    # train: fwd + bwd + remat fwd ~ 3 passes over weights; grads f32 w+r;
    # adam mu/nu r+w f32; master param r+w
    weight_traffic = p_total * (3 * bpe + 8 + 16 + 8)
    return weight_traffic + 3 * L * act_per_layer + 2 * logits


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6*N_active*D for training, 2*N_active*D for inference."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        if shape.n_candidates:
            tokens = (shape.seq_len + shape.n_candidates) * shape.global_batch
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def analyse(arch: str, shape_name: str, mesh_name: str, chips: int,
            cost: dict, collectives: Optional[dict], cfg: ModelConfig,
            shape: ShapeConfig, hw: HardwareSpec = H100,
            per_device_peak_memory: Optional[float] = None,
            params_bytes_chip: Optional[float] = None,
            cache_bytes_chip: Optional[float] = None) -> RooflineReport:
    """``cost`` = :func:`cost_analysis` of one card's step (per partition);
    scaled to all cards.  ``collectives``: its collective bytes
    (:func:`collective_bytes`; None reads them from ``cost``).

    ``params_bytes_chip`` / ``cache_bytes_chip``: the ACTUAL per-card bytes
    of the weights and caches the step reads.  When given, the memory
    estimate charges each card its real weight / cache reads."""
    flops = float(cost.get("flops", 0.0)) * chips
    byts = float(cost.get("bytes accessed", 0.0)) * chips
    coll = collective_bytes(cost) if collectives is None else collectives
    coll_total = float(coll["total"]) * chips   # per partition -> whole job
    if params_bytes_chip is not None:
        w_factor = 19.0 if shape.kind == "train" else 1.0   # passes + opt f32
        est_chip = w_factor * params_bytes_chip + (cache_bytes_chip or 0.0) \
            + (analytic_act_bytes(cfg, shape) / chips)
        mem_est = est_chip / hw.hbm_bw
    else:
        mem_est = analytic_hbm_bytes(cfg, shape) / (chips * hw.hbm_bw)
    return RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops=flops, hlo_bytes=byts, collective_bytes=coll_total,
        model_flops=model_flops(cfg, shape),
        compute_s=flops / (chips * hw.peak_flops),
        memory_s=byts / (chips * hw.hbm_bw),
        collective_s=coll_total / (chips * hw.ici_bw),
        memory_s_est=mem_est,
        per_device_peak_memory=per_device_peak_memory,
        collective_detail={k: v for k, v in coll.items() if k != "counts"},
    )


def analytic_act_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Whole-job activation + logits HBM traffic (layer granularity)."""
    d, f, v, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    bpe = 2
    if shape.kind == "decode":
        return shape.global_batch * v * bpe
    toks = shape.seq_len * shape.global_batch
    if shape.n_candidates:
        toks = (shape.seq_len + shape.n_candidates) * shape.global_batch
    act = toks * (8 * d + 2 * f) * bpe * L
    logits = toks * v * (bpe + 4)
    return (3 * act + 2 * logits) if shape.kind == "train" else (act + logits)
