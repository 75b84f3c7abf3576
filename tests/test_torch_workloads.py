"""The port's copy of `workloads/` compiles every preset to the JAX
package's event list exactly: the same events, field by field, in the
same order (`Event` is a different class in each package, so events are
compared as dicts). Run at the presets' default knobs and at the scale
`tests/test_workloads.py` sweeps, with another seed."""
import dataclasses

import pytest

from repro.workloads import compile_workload as jax_compile_workload
from repro.workloads import presets as jax_presets
from repro_torch.workloads import compile_workload, presets

SCALES = {"default": {},
          "sweep": dict(batches_per_scenario=6, inferences=16,
                        num_scenarios=3, seed=5, fleet_streams=12)}


def _events(events):
    return [dataclasses.asdict(e) for e in events]


@pytest.mark.parametrize("scale", sorted(SCALES))
@pytest.mark.parametrize("name", sorted(jax_presets()))
def test_compile_workload_equals_jax(name, scale):
    port, ref = presets(**SCALES[scale])[name], \
        jax_presets(**SCALES[scale])[name]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    events = compile_workload(port)
    assert events and _events(events) == _events(jax_compile_workload(ref))


def test_the_presets_are_jax_s():
    assert sorted(presets()) == sorted(jax_presets())
