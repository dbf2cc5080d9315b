"""Run-time switches read by the model code.  Port of the MoE dispatch
switch of ``repro/flags.py``.

``MOE_DISPATCH``: ``"gspmd"`` (the default: ``moe_apply``, the sort /
scatter formulation on the rank's own tokens) or ``"a2a"`` (expert
parallelism with explicit all-to-all exchanges, ``moe_apply_a2a``), taken
only under an active mesh (``sharding.mesh_rules``)."""
import contextlib
import contextvars

MOE_DISPATCH = contextvars.ContextVar("repro_torch_moe_dispatch",
                                      default="gspmd")


@contextlib.contextmanager
def moe_dispatch(kind: str):
    if kind not in ("gspmd", "a2a"):
        raise ValueError(f"moe dispatch must be gspmd or a2a, got {kind!r}")
    tok = MOE_DISPATCH.set(kind)
    try:
        yield
    finally:
        MOE_DISPATCH.reset(tok)
