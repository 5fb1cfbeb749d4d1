"""The route of the bfloat16-state field kernels (``ops/field_cuda.py``
``pair_route``), on the CPU: a plain function of the shape, the conductor
box and the tensors' alignment.

* The paired route (two cells along x a thread, as 4-byte words) serves
  the shapes of the records: team7 (102x102x24, box x0 = 1) and scale256
  (256x256x64), both for ``field_a`` and for ``field_u`` over the box.
* float32 coefficients at bfloat16 state pair in ``field_a`` there too,
  and keep ``field_u`` on its one-cell kernel.
* The one-cell kernels serve the rest: an odd nx or box width, the
  V-cycle's odd coarse levels (51 and 13 at team7), unaligned views (a
  float32 ``ka`` off an 8-byte boundary too) and grids whose indices would
  not fit 32 bits.
* A route asked for by name is refused where it does not apply.

The kernels themselves, on both routes, are held against their plain
versions bit for bit on the card (``tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest
import torch

from eddy_currents_3d_tpu_torch.assembly.assemble import assemble_operator
from eddy_currents_3d_tpu_torch.ops import field_cuda
from eddy_currents_3d_tpu_torch.ops.field_cuda import (aligned4, pair_route,
                                                       pairs_aligned)
from eddy_currents_3d_tpu_torch.testing import cases

RECORD_GRIDS = {"team7": (102, 102, 24), "scale256": (256, 256, 64)}


def _conductor_box(model):
    """The conductor box as assembly/assemble.py cuts it: the conducting
    cells' bounding box grown by the 2-cell halo, inside the grid."""
    zz, yy, xx = np.nonzero(np.asarray(model.cond_mask))
    return tuple(v for lo, hi, n in ((zz.min(), zz.max(), model.shape_zyx[0]),
                                     (yy.min(), yy.max(), model.shape_zyx[1]),
                                     (xx.min(), xx.max(), model.shape_zyx[2]))
                 for v in (max(int(lo) - 2, 0), min(int(hi) + 3, n)))


@pytest.mark.parametrize("name", sorted(RECORD_GRIDS))
def test_the_records_shapes_take_the_paired_route(name):
    model = cases.load_case(cases.case_static(shape_xyz=RECORD_GRIDS[name],
                                              steps=2))
    box = _conductor_box(model)
    assert box[4] == 1                      # the box starts at an odd x
    shape = model.shape_zyx
    assert pair_route(shape) == "paired"                   # field_a, L = 3
    assert pair_route(shape, fields=1) == "paired"         # field_a, L = 1
    assert pair_route(shape, box) == "paired"              # field_u


@pytest.mark.parametrize("name", sorted(RECORD_GRIDS))
def test_f32_coefficients_pair_in_field_a_only(name):
    """float32 coefficients at bfloat16 state: field_a's paired kernel
    reads them as float2 pairs; field_u's reads bfloat16 words only."""
    model = cases.load_case(cases.case_static(shape_xyz=RECORD_GRIDS[name],
                                              steps=2))
    box = _conductor_box(model)
    shape = model.shape_zyx
    assert pair_route(shape, coef_bf16=False) == "paired"
    assert pair_route(shape, fields=1, coef_bf16=False) == "paired"
    assert pair_route(shape, box, coef_bf16=False) == "scalar"


def test_conductor_box_is_the_assembled_one():
    """The helper above cuts team7's box as the assembly does."""
    model = cases.load_case(cases.case_static(shape_xyz=(102, 102, 24),
                                              steps=2))
    sysm = assemble_operator(model, torch.float32, "cpu")
    assert sysm.op.box == _conductor_box(model) == (0, 9, 1, 101, 1, 101)


@pytest.mark.parametrize("shape_zyx, box", [
    ((11, 19, 21), None),                     # odd nx: field_a
    ((11, 19, 21), (0, 9, 1, 18, 1, 20)),     # odd nx, even box width
    ((11, 19, 22), (0, 9, 1, 18, 1, 20)),     # even nx, odd box width
    ((12, 51, 51), None),                     # team7's first coarse level
    ((3, 13, 13), None),                      # and its third
], ids=["odd_nx", "odd_nx_even_box", "odd_box", "level_51", "level_13"])
def test_odd_widths_take_the_scalar_route(shape_zyx, box):
    assert pair_route(shape_zyx, box) == "scalar"


def test_vcycle_levels_alternate_routes():
    """team7's V-cycle: the even levels paired, the odd ones scalar."""
    from eddy_currents_3d_tpu_torch.solvers.multigrid import build_mg
    model = cases.load_case(cases.case_static(shape_xyz=(102, 102, 24),
                                              steps=2))
    sysm = assemble_operator(model, torch.float32, "cpu")
    mg = build_mg(sysm.op.ka, dtype=torch.bfloat16, device="cpu")
    shapes = [tuple(lvl.shape) for lvl in mg.levels]
    routes = [pair_route(s) for s in shapes]
    assert shapes[:4] == [(24, 102, 102), (12, 51, 51), (6, 26, 26),
                          (3, 13, 13)]
    assert routes[:4] == ["paired", "scalar", "paired", "scalar"]
    assert routes == ["paired" if s[2] % 2 == 0 else "scalar"
                      for s in shapes]


def test_unaligned_views_take_the_scalar_route():
    base = torch.zeros(2 * 24 * 102 * 102 + 1, dtype=torch.bfloat16)
    whole = base[:-1].view(2, 24, 102, 102)
    view = base[1:].view(2, 24, 102, 102)
    assert aligned4(whole) and not aligned4(view)
    assert not aligned4(whole, view)
    assert pair_route((24, 102, 102), None, aligned4(whole)) == "paired"
    assert pair_route((24, 102, 102), None, aligned4(view)) == "scalar"


@pytest.mark.parametrize("coef", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_coefficients_off_a_pair_take_the_scalar_route(coef):
    """A ka view one coefficient past a pair's boundary: 4 bytes off 8 in
    float32, which the float2 loads refuse, and 2 bytes off 4 in bfloat16;
    a view two coefficients on starts a pair again."""
    base = torch.zeros(7 * 24 * 102 * 102 + 2, dtype=coef)
    A = torch.zeros(3, 24, 102, 102, dtype=torch.bfloat16)
    whole = base[:-2].view(7, 24, 102, 102)
    one = base[1:-1].view(7, 24, 102, 102)
    two = base[2:].view(7, 24, 102, 102)
    f32 = coef == torch.float32
    route = lambda ka: pair_route((24, 102, 102), None,
                                  pairs_aligned(ka, A), coef_bf16=not f32)
    assert aligned4(one) == f32        # float32: a word, not a pair
    assert route(whole) == "paired" and route(one) == "scalar"
    assert route(two) == "paired"


def test_indices_past_32_bits_take_the_scalar_route():
    assert pair_route((1024, 512, 512)) == "scalar"
    assert pair_route((256, 512, 512)) == "paired"


@pytest.mark.parametrize("asked, choice, taken", [
    (None, "paired", "paired"), (None, "scalar", "scalar"),
    ("scalar", "paired", "scalar"), ("scalar", "scalar", "scalar"),
    ("paired", "paired", "paired"), ("paired", "scalar", ValueError),
    ("pairs", "paired", ValueError)])
def test_a_route_asked_for_by_name(asked, choice, taken):
    if taken is ValueError:
        with pytest.raises(ValueError):
            field_cuda._chosen(asked, choice)
    else:
        assert field_cuda._chosen(asked, choice) == taken


def test_cpu_tensors_take_the_plain_version_on_any_route():
    """On the CPU the wrappers run the plain version, with no route count."""
    model = cases.load_case(cases.case_static(shape_xyz=(14, 13, 11), steps=2))
    sysm = assemble_operator(model, torch.float32, "cpu")
    from eddy_currents_3d_tpu_torch.ops.field import (FieldStencilOperator,
                                                      field_a_reference)
    op = FieldStencilOperator.from_assembled(sysm)
    A = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3,) + model.shape_zyx)).float()
    w = field_cuda.field_a
    before = (w.launches, w.paired.launches, w.scalar.launches)
    for route in (None, "paired", "scalar"):
        assert torch.equal(w(op.ka, A, route=route),
                           field_a_reference(op.ka, A))
    assert (w.launches, w.paired.launches, w.scalar.launches) == before
