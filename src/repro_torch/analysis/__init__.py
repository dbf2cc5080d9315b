"""flamecheck for the PyTorch port — repo-specific static analysis of the
port's serving stack (a copy of ``repro/analysis``, with torch's syncs).

Three passes (see the module docstrings for details):

- :mod:`repro_torch.analysis.lock_discipline` — unguarded shared-state
  access in the threaded classes;
- :mod:`repro_torch.analysis.host_sync` — hidden device→host syncs (torch's:
  ``.item()``, ``.cpu()``, ``.tolist()``, ``torch.cuda.synchronize``, ...)
  reachable from the serving hot path;
- :mod:`repro_torch.analysis.future_leak` — response futures that can be
  dropped unresolved.

The JAX package's two other passes check ``jax.jit`` recompiles and Pallas
BlockSpec contracts; their torch counterparts are not written yet.

Run as ``python -m repro_torch.analysis [--strict]``; stdlib-only (imports
neither torch nor numpy) so it is fast enough to gate CI.
"""
from repro_torch.analysis.common import Finding, ModuleSource  # noqa: F401
