"""flamecheck for the PyTorch port — repo-specific static analysis of the
port's serving stack (a copy of ``repro/analysis``, with torch's syncs).

Five passes, JAX's five (see the module docstrings for details):

- :mod:`repro_torch.analysis.lock_discipline` — unguarded shared-state
  access in the threaded classes;
- :mod:`repro_torch.analysis.host_sync` — hidden device→host syncs (torch's:
  ``.item()``, ``.cpu()``, ``.tolist()``, ``torch.cuda.synchronize``, ...)
  reachable from the serving hot path;
- :mod:`repro_torch.analysis.recompile` — CUDA-graph capture hazards: a
  capture reachable from the hot path, a host sync, a branch on a tensor
  value or a read of host state that changes after construction inside a
  captured executor (a replay keeps what the capture saw), and the JAX
  pass's executor cache-key and shape-branch rules;
- :mod:`repro_torch.analysis.kernel_contracts` — the CUDA kernels' C ABI
  (each ``_build.function`` binding against its ``extern "C"`` definition:
  symbol, arity, argument kinds, out-buffer widths) and launch contracts
  (the current stream, a dim guard and ``forbid_grad`` before a launch);
- :mod:`repro_torch.analysis.future_leak` — response futures that can be
  dropped unresolved.

Run as ``python -m repro_torch.analysis [--strict]``; stdlib-only (imports
neither torch nor numpy) so it is fast enough to gate CI.
"""
from repro_torch.analysis.common import Finding, ModuleSource  # noqa: F401
