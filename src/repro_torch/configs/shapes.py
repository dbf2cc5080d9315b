"""Workload shapes: the assignment's four and the paper's own SUMI serving
scenarios (Table 2: history + candidates per request).  A copy of
``repro/configs/shapes.py``."""
from repro_torch.types import ShapeConfig

TRAIN_4K = ShapeConfig(name="train_4k", seq_len=4096, global_batch=256,
                       kind="train")
PREFILL_32K = ShapeConfig(name="prefill_32k", seq_len=32768, global_batch=32,
                          kind="prefill")
DECODE_32K = ShapeConfig(name="decode_32k", seq_len=32768, global_batch=128,
                         kind="decode")
LONG_500K = ShapeConfig(name="long_500k", seq_len=524288, global_batch=1,
                        kind="decode")

CLIMBER_BASE = ShapeConfig(name="climber_base", seq_len=512, global_batch=32,
                           kind="prefill", n_candidates=128)
CLIMBER_LONG = ShapeConfig(name="climber_long", seq_len=1024, global_batch=32,
                           kind="prefill", n_candidates=512)

SHAPES = {s.name: s for s in
          [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K, CLIMBER_BASE,
           CLIMBER_LONG]}

ASSIGNED_SHAPES = [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
