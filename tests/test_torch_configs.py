"""The port's config reduction against the reference's.

``repro_torch.configs.reduce`` is applied to each of the JAX package's 11
configs (rebuilt from their fields as the port's dataclasses) and every
field of the result is compared with ``repro.configs.reduced_config``; the
port's registry holds all 11, each equal to the JAX config field by field.
No field differs: where the port's modules read a field differently, this
test would name it.
"""
import dataclasses

import pytest

from repro import configs as j_configs
from repro_torch import types as T
from repro_torch.configs import all_configs, get_config, reduce, \
    reduced_config

ARCHS = sorted(all_configs())


def _port_config(jcfg) -> T.ModelConfig:
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    if jcfg.moe is not None:
        fields["moe"] = T.MoEConfig(**dataclasses.asdict(jcfg.moe))
    if jcfg.climber is not None:
        fields["climber"] = T.ClimberConfig(**dataclasses.asdict(jcfg.climber))
    return T.ModelConfig(**fields)


def test_all_eleven_configs_are_compared():
    assert len(ARCHS) == 11
    assert ARCHS == sorted(j_configs.all_configs())


@pytest.mark.parametrize("arch", ARCHS)
def test_reduce_matches_reference_field_by_field(arch):
    got = dataclasses.asdict(reduce(_port_config(j_configs.get_config(arch))))
    want = dataclasses.asdict(j_configs.reduced_config(arch))
    assert got.keys() == want.keys()
    diff = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not diff, f"{arch}: fields differ (port, reference): {diff}"


@pytest.mark.parametrize("arch", ARCHS)
def test_registered_archs_reduce_through_the_registry(arch):
    """``reduced_config`` of a registered arch is ``reduce`` of its config,
    and the port's own config equals the reference's field by field."""
    assert reduced_config(arch) == reduce(get_config(arch))
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        j_configs.get_config(arch))
