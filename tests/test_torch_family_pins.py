"""The smoke's 256² pins of the BLA frames (``chip_smoke.py``
``FAMILY_PINS``, phase 14) against the JAX package's CLI on the CPU with
FMA off: the values the card's K15 frames are held to.  (The other
families' pins: ``test_torch_families.py``; the port's twins equal the
JAX package at 8²-32² in ``test_torch_families_bla.py`` and
``test_torch_bla.py``.)
"""

import pytest

import test_torch_jaxref as ref
from test_torch_families import jax_pins

PINNED = ("Cpu64PerturbedBLA", "GpuHDRx32PerturbedBLA",
          "GpuHDRx64PerturbedBLA")


def _jax_reference(_inputs):
    return jax_pins(PINNED)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_family_pins", "_jax_reference",
                                 tmp_path_factory.mktemp("family_pins"))


@pytest.mark.parametrize("name", PINNED)
def test_smoke_pin_equals_jax(jax_ref, name):
    import chip_smoke as cs
    assert tuple(int(v) for v in jax_ref["pin_" + name]) == \
        cs.FAMILY_PINS[name][2]
