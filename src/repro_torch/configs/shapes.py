"""The paper's own SUMI serving scenarios (Table 2): history + candidates
per request."""
from repro_torch.types import ShapeConfig

CLIMBER_BASE = ShapeConfig(name="climber_base", seq_len=512, global_batch=32,
                           kind="prefill", n_candidates=128)
CLIMBER_LONG = ShapeConfig(name="climber_long", seq_len=1024, global_batch=32,
                           kind="prefill", n_candidates=512)
