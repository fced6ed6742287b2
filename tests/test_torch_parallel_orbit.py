"""The mesh-sharded orbit step of the PyTorch/CUDA port
(``parallel/orbit_sharded.py``) on the CPU: the cases of the JAX package's
``tests/test_parallel_orbit.py`` with M = 2 and 4 ranks in one gloo
process group (subprocesses; M = 2 on a subgroup of ranks 0 and 1), each
equal to the JAX package's sharded step (4 virtual devices) and to the
port's one-device step (K4 and K5's twins), bit for bit: both 512-limb
coordinates over 4 steps, the View #30 operand at 16,384 limbs, the
6-step chunk at 256 limbs, rows included; K20's twins, fed from the
reshard's all_to_all receive buffer, equal the JAX package's algorithm in
torch (``sharded_tail_reference``, this file's oracle) on every rank; two
steps through one workspace equal two through fresh ones; the sharded
session (``compute_reference_orbit_device(mesh=)``) returns the
one-device session's orbit and reuse copy.  In one process: K20's twins
block by block, from receive buffers built as the all_to_all would,
equal K20's first form's twins after the plain reshard
(``present_tail_a``/``_b``, kept here as the oracle of the new layout)
and the whole-vector tail, on a step and on Hypothesis cases of carries
and borrows across block edges held against Python ints; the refusals.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings, strategies as st

import test_torch_jaxref as ref
from fractalshark_tpu_torch.core.highprecision import HighPrecision
from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
from fractalshark_tpu_torch.ops.bignum import ntt as N
from fractalshark_tpu_torch.ops.bignum import ntt_pallas as NP
from fractalshark_tpu_torch.ops.bignum import orbit as O
from fractalshark_tpu_torch.parallel import mesh as PM
from fractalshark_tpu_torch.parallel import orbit_sharded as OS
from fractalshark_tpu_torch.parallel.mesh import Mesh

MESHES = (2, 4)
COORDS = (("-0.743643887037158704752191506114774",
           "0.131825904205311970493132056385139"),
          ("-1.999999999999", "0.0000000000001"))   # View-#30-like 0xFFFF run
STEPS = 4
CHUNK_C = ("-0.7436438870371587", "0.1318259042053119")
CHUNK_STEPS = 6
# meshes with fewer than 8 columns a rank, so that the halo below a block
# spans ranks: (M, limbs), CHUNK_C over NARROW_STEPS steps, M = 8 on a
# subgroup of ranks 0-7 (8 at 256 limbs is the JAX package's dry run,
# __graft_entry__.py dryrun_multichip(8): 4 columns a rank; 16 at 256: 2)
NARROW = ((8, 256), (16, 512), (16, 256))
NARROW_WORLD = 16
NARROW_STEPS = 3
# the sharded session: 128 limbs (nfft 512: four ranks of 8 columns)
SESSION = ("-0.743643887037158704752191506114774",
           "0.131825904205311970493132056385139", "1e-9", 100, 128, 32)


def _coords(cx: str, cy: str, limbs: int):
    spec = FP.FixedSpec.for_limbs(limbs)
    prec = spec.frac_bits - 20
    return (spec,) + FP.hp_to_digits(HighPrecision(cx, prec=prec), spec) \
        + FP.hp_to_digits(HighPrecision(cy, prec=prec), spec)


def _view30(pkg_views):
    spec = FP.FixedSpec.for_limbs(16384)
    prec = spec.frac_bits - 20
    ptz = pkg_views.get_view_preset(30).ptz
    return (spec,) + FP.hp_to_digits(ptz.pt_x.with_precision(prec), spec) \
        + FP.hp_to_digits(ptz.pt_y.with_precision(prec), spec)


# --------------------------------------------- the JAX algorithm, in torch
# The JAX package's sharded tail itself (fractalshark_tpu/parallel/
# orbit_sharded.py: four carry passes, each a Kogge-Stone scan with its
# own gathers; the line numbers below are that file's) over the port's
# collectives: the oracle between the JAX package and K20's twins.
MASK = FP.DIGIT_MASK
_P1P2 = N.P1 * N.P2


def _from_prev(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rank r gets rank r − 1's ``t``; rank 0 zeros (``:62-68``)."""
    prev = PM.all_gather(mesh, t)
    return prev[mesh.rank - 1] if mesh.rank else torch.zeros_like(t)


def _pshift(a: torch.Tensor, k: int, mesh: Mesh) -> torch.Tensor:
    """out[i] = a[i − k] over the global digit order (``:71-78``)."""
    if k == 0:
        return a
    return torch.cat([_from_prev(a[..., -k:].contiguous(), mesh),
                      a[..., :-k]], -1)


def _ks_gp(g: torch.Tensor, p: torch.Tensor):
    """Inclusive Kogge-Stone prefix of the carry monoid (``:49-59``)."""
    L, k = g.shape[-1], 1
    while k < L:
        gs = torch.nn.functional.pad(g, (k, 0))[..., :L]
        ps = torch.nn.functional.pad(p, (k, 0), value=1)[..., :L]
        g, p = g | (p & gs), p & ps
        k <<= 1
    return g, p


def _pcarry(acc: torch.Tensor, mesh: Mesh, ret_cout: bool = False):
    """Sharded carry_propagate of digit sums (``:81-108``)."""
    hi = acc >> 16
    a = (acc & MASK) + _pshift(hi, 1, mesh)
    d = a & MASK
    G, Pp = _ks_gp(a >> 16, (d == MASK).long())
    allG = PM.all_gather(mesh, G[..., -1].contiguous())
    allP = PM.all_gather(mesh, Pp[..., -1].contiguous())
    C = torch.zeros_like(G[..., -1])
    for j in range(mesh.rank):
        C = allG[j] | (allP[j] & C)
    Gtot = G | (Pp & C[..., None])
    out = (d + torch.cat([C[..., None], Gtot[..., :-1]], -1)) & MASK
    if not ret_cout:
        return out
    couts = PM.all_gather(mesh, (hi[..., -1] | Gtot[..., -1]).contiguous())
    return out, couts[mesh.size - 1]


def _psigned_finish(acc_p, acc_n, mesh: Mesh):
    """(sign [K], digits [K, Lloc]) of pos − neg (``:111-127``)."""
    Pd = _pcarry(acc_p, mesh)
    Nd = _pcarry(acc_n, mesh)
    one = torch.zeros_like(Pd)
    if mesh.rank == 0:
        one[..., 0] = 1
    u, cout = _pcarry(Pd + (MASK - Nd) + one, mesh, ret_cout=True)
    v = _pcarry((MASK - u) + one, mesh)
    pos = cout > 0
    mag = torch.where(pos[..., None], u, v)
    nz = PM.all_reduce(mesh, mag.max(-1).values, dist.ReduceOp.MAX) > 0
    return torch.where(pos | ~nz, 1, -1).to(torch.int32), mag


def _pparts_acc(v: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A 64-bit coefficient's four 16-bit parts at digits k..k+3
    (``:130-136``)."""
    acc = v & MASK
    for k in (1, 2, 3):
        acc = acc + _pshift((v >> (16 * k)) & MASK, k, mesh)
    return acc


def _pstreams(r1, r2, mesh: Mesh, signed: bool, double: bool, gsign=0):
    """(acc_p, acc_n) of one CRT'd product row pair (``:139-167``)."""
    rec = FP._crt_rec(r1, r2)
    if signed:
        neg = rec > _P1P2 // 2
        nrec = _P1P2 - rec
        if double:
            rec, nrec = rec << 1, nrec << 1
        return (_pparts_acc(torch.where(neg, 0, rec), mesh),
                _pparts_acc(torch.where(neg, nrec, 0), mesh))
    if double:
        rec = rec << 1
    parts = _pparts_acc(rec, mesh)
    z = torch.zeros_like(parts)
    return (parts, z) if gsign > 0 else (z, parts)


def sharded_tail_reference(r: torch.Tensor, cfx: torch.Tensor,
                           cfy: torch.Tensor, rnd: torch.Tensor, sgs,
                           mesh: Mesh):
    """The JAX package's sharded tail (``:251-262``) on the rank's block:
    r int32 [4, Lloc] residue rows (x² − y² mod p1, p2, x·y mod p1, p2),
    the block's addend planes cfx, cfy and round plane (int32 [Lloc]),
    sgs = (scx, scy, sx·sy).  Returns (signs int32 [2], digits int32 [2,
    Lloc])."""
    scx, scy, sxy = (int(v) for v in sgs)
    px, nx = _pstreams(r[0], r[1], mesh, signed=True, double=False)
    py, ny = _pstreams(r[2], r[3], mesh, signed=False, double=True,
                       gsign=sxy)
    cfx, cfy, rnd = (t.to(torch.int64) for t in (cfx, cfy, rnd))
    z = torch.zeros_like(cfx)
    px = px + (cfx if scx > 0 else z) + rnd
    nx = nx + (z if scx > 0 else cfx)
    py = py + (cfy if scy > 0 else z) + rnd
    ny = ny + (z if scy > 0 else cfy)
    sign, mag = _psigned_finish(torch.stack([px, py]), torch.stack([nx, ny]),
                                mesh)
    return sign, mag.to(torch.int32)


def _jax_reference(_inputs):
    import jax
    import jax.numpy as jnp

    from fractalshark_tpu.core import views as jviews
    from fractalshark_tpu.core.highprecision import HighPrecision as JHP
    from fractalshark_tpu.ops.bignum import fixedpoint as JFP
    from fractalshark_tpu.ops.bignum.orbit import orbit_chunk
    from fractalshark_tpu.parallel import orbit_sharded as JOS

    mesh = JOS.make_limb_mesh(jax.devices()[:4])
    out = {}

    def spec_of(limbs):
        return JFP.FixedSpec.for_limbs(limbs)

    def run(spec, scx, cxd, scy, cyd, steps, key):
        cxj, cyj = jnp.asarray(cxd), jnp.asarray(cyd)
        s = (jnp.int32(scx), cxj, jnp.int32(scy), cyj)
        for k in range(steps):
            s = JOS.iterate_z_sharded(*s, jnp.int32(scx), cxj,
                                      jnp.int32(scy), cyj, spec=spec,
                                      mesh=mesh)
            for i, v in enumerate(s):
                out[f"{key}_{k}_{i}"] = np.asarray(v)

    for c, (cx, cy) in enumerate(COORDS):
        spec = spec_of(512)
        prec = spec.frac_bits - 20
        scx, cxd = JFP.hp_to_digits(JHP(cx, prec=prec), spec)
        scy, cyd = JFP.hp_to_digits(JHP(cy, prec=prec), spec)
        run(spec, scx, cxd, scy, cyd, STEPS, f"c{c}")
    spec = spec_of(16384)
    prec = spec.frac_bits - 20
    ptz = jviews.get_view_preset(30).ptz
    scx, cxd = JFP.hp_to_digits(ptz.pt_x.with_precision(prec), spec)
    scy, cyd = JFP.hp_to_digits(ptz.pt_y.with_precision(prec), spec)
    run(spec, scx, cxd, scy, cyd, 1, "v30")
    spec = spec_of(256)
    prec = spec.frac_bits - 20
    cx, cy = JHP(CHUNK_C[0], prec=prec), JHP(CHUNK_C[1], prec=prec)
    scx, cxd = JFP.hp_to_digits(cx, spec)
    scy, cyd = JFP.hp_to_digits(cy, spec)
    args = (jnp.int32(scx), jnp.asarray(cxd), jnp.int32(scy),
            jnp.asarray(cyd))
    st_, _ = orbit_chunk(*args, jnp.float64(1.0), jnp.float64(0.0),
                         jnp.int32(0), *args, jnp.float64(1.0),
                         jnp.int32(-40), jnp.float64(float(cx)),
                         jnp.float64(float(cy)), spec=spec,
                         steps=CHUNK_STEPS, mesh=mesh)
    for i, v in enumerate(st_[:4]):
        out[f"chunk_{i}"] = np.asarray(v)
    return out


def _jax_narrow(_inputs):
    import jax
    import jax.numpy as jnp

    from fractalshark_tpu.core.highprecision import HighPrecision as JHP
    from fractalshark_tpu.ops.bignum import fixedpoint as JFP
    from fractalshark_tpu.ops.bignum.orbit import orbit_chunk
    from fractalshark_tpu.parallel import orbit_sharded as JOS

    out = {}
    for M, limbs in NARROW:
        mesh = JOS.make_limb_mesh(jax.devices()[:M])
        spec = JFP.FixedSpec.for_limbs(limbs)
        prec = spec.frac_bits - 20
        cx, cy = JHP(CHUNK_C[0], prec=prec), JHP(CHUNK_C[1], prec=prec)
        scx, cxd = JFP.hp_to_digits(cx, spec)
        scy, cyd = JFP.hp_to_digits(cy, spec)
        args = (jnp.int32(scx), jnp.asarray(cxd), jnp.int32(scy),
                jnp.asarray(cyd))
        st_, _ = orbit_chunk(*args, jnp.float64(1.0), jnp.float64(0.0),
                             jnp.int32(0), *args, jnp.float64(1.0),
                             jnp.int32(-40), jnp.float64(float(cx)),
                             jnp.float64(float(cy)), spec=spec,
                             steps=NARROW_STEPS, mesh=mesh)
        for i, v in enumerate(st_[:4]):
            out[f"{M}_{limbs}_{i}"] = np.asarray(v)
    return out


def _narrow_rank_cases(rank: int, world: int) -> dict:
    import torch.distributed as dist
    sub = dist.new_group(list(range(8)))
    out = {}
    for M, limbs in NARROW:
        if rank >= M:
            continue
        mesh = OS.make_limb_mesh("cpu", None if M == world else sub)
        spec, *cs = _coords(*CHUNK_C, limbs)
        scx, cx, scy, cy = _state(*cs)
        state = O.OrbitState(cs[0], cs[1], cs[2], cs[3], "cpu")
        rows = O.orbit_chunk(state, scx, cx, scy, cy, spec, NARROW_STEPS,
                             mesh=mesh)
        out[f"{M}_{limbs}_rows"] = rows.numpy()
        out[f"{M}_{limbs}_x"] = state.x.numpy()
        out[f"{M}_{limbs}_y"] = state.y.numpy()
        out[f"{M}_{limbs}_row"] = state.row.numpy()
    return out


def _state(scx, cxd, scy, cyd):
    cx = torch.from_numpy(cxd.astype(np.int32))
    cy = torch.from_numpy(cyd.astype(np.int32))
    return (scx, cx, scy, cy)


def _rank_cases(rank: int, world: int) -> dict:
    import torch.distributed as dist

    from fractalshark_tpu_torch.core import views
    sub = dist.new_group([0, 1])
    out = {}
    for M in MESHES:
        if rank >= M:
            continue
        mesh = OS.make_limb_mesh("cpu", None if M == world else sub)
        for c, (cx, cy) in enumerate(COORDS):
            spec, *cs = _coords(cx, cy, 512)
            s = c0 = _state(*cs)
            for k in range(STEPS):
                s = OS.iterate_z_sharded(*s, *c0, spec=spec, mesh=mesh)
                for i, v in enumerate(s):
                    out[f"{M}_c{c}_{k}_{i}"] = np.asarray(v)
        spec, *cs = _view30(views)
        c0 = _state(*cs)
        s = OS.iterate_z_sharded(*c0, *c0, spec=spec, mesh=mesh)
        for i, v in enumerate(s):
            out[f"{M}_v30_0_{i}"] = np.asarray(v)
        # K20's twins (the default CPU path), fed from the receive
        # buffer, against the JAX algorithm
        x, y = c0[1], c0[3]
        lay = OS.Layout(*N.split_n(spec.nfft), M, rank)
        inv = OS.inverse_block(x, y, spec, mesh)
        recv = PM.all_to_all(mesh, OS.pack(inv, lay))
        cadd, rnd = OS.local_planes(c0[1], c0[3], spec, mesh)
        sgs = (c0[0], c0[2], c0[0] * c0[2])
        cfg = NP.tail_cfg(sgs + (0,), nr=False)
        dig, sgn = OS.sharded_tail(recv, cadd, rnd, cfg, lay, mesh)
        rsgn, rdig = sharded_tail_reference(
            OS.reshard(inv, mesh).reshape(4, -1)[:, OS.HALO:],
            cadd[0, OS.HALO:], cadd[1, OS.HALO:], rnd[OS.HALO:], sgs, mesh)
        out[f"{M}_k20"] = dig.numpy()
        out[f"{M}_k20_sgn"] = sgn.numpy()
        out[f"{M}_ref"] = rdig.numpy()
        out[f"{M}_ref_sgn"] = rsgn.numpy()
        # two steps through one workspace, two through fresh ones
        spec, *cs = _coords(*COORDS[1], 512)
        scx, cx, scy, cy = _state(*cs)
        planes = OS.local_planes(cx, cy, spec, mesh)
        cfg = NP.tail_cfg((scx, scy, 1, 0), nr=False)
        one = OS.Workspace(spec, mesh)
        one.bind(planes, cfg)
        for fresh in (False, True):
            x, y = cx, cy
            zsign = torch.tensor([scx, scy], dtype=torch.int32)
            for k in range(2):
                ws = one
                if fresh:
                    ws = OS.Workspace(spec, mesh)
                    ws.bind(planes, cfg)
                full, sgn = OS._step(x, y, zsign, spec, mesh, ws)
                zsign = sgn.clone()
                F, D = spec.frac_digits, spec.digits
                x, y = full[0, F:F + D].clone(), full[1, F:F + D].clone()
                out[f"{M}_ws{int(fresh)}_{k}"] = np.concatenate(
                    [zsign.numpy(), x.numpy(), y.numpy()])
        # the 6-step chunk, rows included
        spec, *cs = _coords(*CHUNK_C, 256)
        scx, cx, scy, cy = _state(*cs)
        state = O.OrbitState(cs[0], cs[1], cs[2], cs[3], "cpu")
        rows = O.orbit_chunk(state, scx, cx, scy, cy, spec, CHUNK_STEPS,
                             mesh=mesh)
        out[f"{M}_chunk_rows"] = rows.numpy()
        out[f"{M}_chunk_x"] = state.x.numpy()
        out[f"{M}_chunk_y"] = state.y.numpy()
        out[f"{M}_chunk_row"] = state.row.numpy()
        # the session, with the reuse copy
        cxs, cys, rad, budget, limbs, chunk = SESSION
        res = O.compute_reference_orbit_device(
            HighPrecision(cxs, prec=1000), HighPrecision(cys, prec=1000),
            budget, HighPrecision(rad, prec=64), limbs32=limbs,
            chunk_steps=chunk, reuse_frac_bits=64, mesh=mesh, device="cpu")
        out[f"{M}_orbit_x"] = res.orbit_x
        out[f"{M}_orbit_y"] = res.orbit_y
        out[f"{M}_orbit_n"] = np.asarray([res.period, res.escaped_at])
        ro = res.extra["reuse_orbit"]
        out[f"{M}_reuse"] = np.asarray([str(v) for v in ro.zx + ro.zy])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ref.run_ranks_and_jax("test_torch_parallel_orbit", 4,
                                 tmp_path_factory.mktemp("parallel_orbit"),
                                 4)


@pytest.fixture(scope="module")
def narrow_runs(tmp_path_factory):
    return ref.run_ranks_and_jax("test_torch_parallel_orbit", NARROW_WORLD,
                                 tmp_path_factory.mktemp("parallel_narrow"),
                                 NARROW_WORLD, "_narrow_rank_cases",
                                 "_jax_narrow")


def _single_steps(spec, cs, steps):
    s = c0 = _state(*cs)
    out = []
    for _ in range(steps):
        s = FP.iterate_z(*s, *c0, spec)
        out.append(s)
    return out


def _assert_state(got: dict, key: str, want, jref, jkey):
    for i in range(4):
        g = got[f"{key}_{i}"]
        np.testing.assert_array_equal(g, np.asarray(want[i]))
        np.testing.assert_array_equal(g.astype(jref[f"{jkey}_{i}"].dtype),
                                      jref[f"{jkey}_{i}"])


@pytest.mark.parametrize("M", MESHES)
@pytest.mark.parametrize("c", range(len(COORDS)))
def test_iterate_z_sharded_bit_identical(runs, M, c):
    """4 steps at 512 limbs (nfft 2,048): every rank = the one-device
    step = the JAX package's sharded step, each step."""
    ranks, jref = runs
    spec, *cs = _coords(*COORDS[c], 512)
    single = _single_steps(spec, cs, STEPS)
    for r in range(M):
        for k in range(STEPS):
            _assert_state(ranks[r], f"{M}_c{c}_{k}", single[k], jref,
                          f"c{c}_{k}")


@pytest.mark.parametrize("M", MESHES)
def test_iterate_z_sharded_view30_operand_size(runs, M):
    """One update at the 16,384-limb View #30 operand (nfft 65,536)."""
    from fractalshark_tpu_torch.core import views
    ranks, jref = runs
    spec, *cs = _view30(views)
    single = _single_steps(spec, cs, 1)
    for r in range(M):
        _assert_state(ranks[r], f"{M}_v30_0", single[0], jref, "v30_0")


@pytest.mark.parametrize("M", MESHES)
def test_k20_twins_equal_the_jax_algorithm(runs, M):
    """On the View #30 step's block of every rank, K20's twins (launch A,
    the words' all_gather, launch B) = the JAX package's four-pass
    algorithm over the group's collectives: digits and signs."""
    ranks, _ = runs
    for r in range(M):
        np.testing.assert_array_equal(ranks[r][f"{M}_k20"],
                                      ranks[r][f"{M}_ref"])
        np.testing.assert_array_equal(ranks[r][f"{M}_k20_sgn"],
                                      ranks[r][f"{M}_ref_sgn"])


@pytest.mark.parametrize("M", MESHES)
def test_two_steps_through_one_workspace_equal_fresh_ones(runs, M):
    """Two steps in a row through one ``Workspace`` (its buffers, the
    signs read from its own ``sgn``) = two steps each through a fresh
    one, on every rank, and = the one-device steps."""
    ranks, _ = runs
    spec, *cs = _coords(*COORDS[1], 512)
    single = _single_steps(spec, cs, 2)
    for r in range(M):
        for k in range(2):
            got = ranks[r][f"{M}_ws0_{k}"]
            np.testing.assert_array_equal(got, ranks[r][f"{M}_ws1_{k}"])
            s = single[k]
            np.testing.assert_array_equal(got, np.concatenate(
                [[int(s[0]), int(s[2])], s[1].numpy(), s[3].numpy()]))


@pytest.mark.parametrize("M", MESHES)
def test_orbit_chunk_sharded_matches_single(runs, M):
    """The 6-step chunk at 256 limbs over the mesh = the one-device chunk
    (orbit_chunk_plain), rows included, and its state = the JAX package's
    sharded chunk's."""
    ranks, jref = runs
    spec, *cs = _coords(*CHUNK_C, 256)
    scx, cx, scy, cy = _state(*cs)
    x, y = torch.from_numpy(cs[1].astype(np.int32)), \
        torch.from_numpy(cs[3].astype(np.int32))
    row = torch.from_numpy(FP.shadow_row_np(cs[0], cs[1], cs[2], cs[3]))
    wx, wy, wrows = O.orbit_chunk_plain(x, y, row, scx, cx, scy, cy, spec,
                                        CHUNK_STEPS)
    for r in range(M):
        got = ranks[r]
        np.testing.assert_array_equal(got[f"{M}_chunk_rows"],
                                      wrows[:CHUNK_STEPS].numpy())
        np.testing.assert_array_equal(got[f"{M}_chunk_row"],
                                      wrows[CHUNK_STEPS].numpy())
        np.testing.assert_array_equal(got[f"{M}_chunk_x"], wx.numpy())
        np.testing.assert_array_equal(got[f"{M}_chunk_y"], wy.numpy())
        np.testing.assert_array_equal(got[f"{M}_chunk_x"].astype(np.uint32),
                                      jref["chunk_1"])
        np.testing.assert_array_equal(got[f"{M}_chunk_y"].astype(np.uint32),
                                      jref["chunk_3"])
        assert got[f"{M}_chunk_row"][10] == jref["chunk_0"]
        assert got[f"{M}_chunk_row"][11] == jref["chunk_2"]


@pytest.mark.parametrize("M,limbs", NARROW)
def test_orbit_chunk_sharded_on_narrow_meshes(narrow_runs, M, limbs):
    """Meshes that leave a rank fewer than 8 columns, so that the 8
    coefficients below a block come from two or four ranks: the 3-step
    chunk from the dry run's centre on every rank = the one-device chunk
    (orbit_chunk_plain), rows included, and its state = the JAX
    package's sharded chunk on as many virtual devices; exact."""
    ranks, jref = narrow_runs
    spec, *cs = _coords(*CHUNK_C, limbs)
    assert N.split_n(spec.nfft)[1] // M < OS.HALO
    scx, cx, scy, cy = _state(*cs)
    x, y = torch.from_numpy(cs[1].astype(np.int32)), \
        torch.from_numpy(cs[3].astype(np.int32))
    row = torch.from_numpy(FP.shadow_row_np(cs[0], cs[1], cs[2], cs[3]))
    wx, wy, wrows = O.orbit_chunk_plain(x, y, row, scx, cx, scy, cy, spec,
                                        NARROW_STEPS)
    key = f"{M}_{limbs}"
    for r in range(M):
        got = ranks[r]
        np.testing.assert_array_equal(got[f"{key}_rows"],
                                      wrows[:NARROW_STEPS].numpy())
        np.testing.assert_array_equal(got[f"{key}_row"],
                                      wrows[NARROW_STEPS].numpy())
        np.testing.assert_array_equal(got[f"{key}_x"], wx.numpy())
        np.testing.assert_array_equal(got[f"{key}_y"], wy.numpy())
        np.testing.assert_array_equal(got[f"{key}_x"].astype(np.uint32),
                                      jref[f"{key}_1"])
        np.testing.assert_array_equal(got[f"{key}_y"].astype(np.uint32),
                                      jref[f"{key}_3"])
        assert got[f"{key}_row"][10] == jref[f"{key}_0"]
        assert got[f"{key}_row"][11] == jref[f"{key}_2"]


def test_halo_owners_span_the_ranks_that_hold_the_columns():
    """The halo's owners: rank M − 1 alone with 8 columns a rank or more;
    the last 2 and 4 ranks with 4 and 2; rank 0's halo empty."""
    for (n1, n2, M), want in (((16, 32, 4), [3] * 8),
                              ((32, 32, 8), [6] * 4 + [7] * 4),
                              ((32, 32, 16), [12, 12, 13, 13, 14, 14, 15,
                                              15])):
        own = OS.halo_owners(n1, n2, M)
        assert (own[0] == -1).all()
        for s in range(1, M):
            assert list(own[s, 0]) == want
            assert (own[s, 1] == s * n1 // M - 1).all()
            assert list(own[s, 0] * (n2 // M) + own[s, 2]) == \
                list(range(n2 - 8, n2))


@pytest.mark.parametrize("M", MESHES)
def test_sharded_session_equals_one_device(runs, M):
    """``compute_reference_orbit_device(mesh=)``: every rank returns the
    one-device session's orbit, its period and its reuse copy exactly."""
    ranks, _ = runs
    cxs, cys, rad, budget, limbs, chunk = SESSION
    res = O.compute_reference_orbit_device(
        HighPrecision(cxs, prec=1000), HighPrecision(cys, prec=1000),
        budget, HighPrecision(rad, prec=64), limbs32=limbs,
        chunk_steps=chunk, reuse_frac_bits=64, device="cpu")
    ro = res.extra["reuse_orbit"]
    for r in range(M):
        got = ranks[r]
        assert ref.bits_equal(got[f"{M}_orbit_x"], res.orbit_x)
        assert ref.bits_equal(got[f"{M}_orbit_y"], res.orbit_y)
        assert list(got[f"{M}_orbit_n"]) == [res.period, res.escaped_at]
        assert list(got[f"{M}_reuse"]) == [str(v) for v in ro.zx + ro.zy]


# ------------------------------------------------- K20 in one process
# The twins of K20's first form (rows after the plain reshard, per-tile
# words), kept as the oracle of the new layout: the receive buffer read in
# place and per-rank words.
PRESENT_TILE_SEGS = 256


def _present_fold(f, z):
    while f.shape[-2] > 1:
        f, z = OS._compose(f[..., 1::2, :], z[..., 1::2, :],
                           f[..., 0::2, :], z[..., 0::2, :])
    return f[..., 0, :], z[..., 0, :]


def present_tail_a(rows, cadd, rnd, cfg):
    """The first form's launch-A twin: (digits, segment words, each 1,024-digit
    tile's composed word then the raw top carry)."""
    K, lloc = rows.shape[0], rows.shape[2] - OS.HALO
    dig, f, z, top = OS._segments(rows, cadd, rnd, cfg)
    G = lloc // OS.SEG
    T = -(-G // PRESENT_TILE_SEGS)
    fi, zi = OS._identity((K, T * PRESENT_TILE_SEGS - G), rows.device)
    tf, tz = _present_fold(
        torch.cat([f, fi], 1).view(K, T, PRESENT_TILE_SEGS, 3),
        torch.cat([z, zi], 1).view(K, T, PRESENT_TILE_SEGS, 3))
    words = torch.cat([OS._encode(tf, tz), top.view(K, 1).to(torch.int32)],
                      1)
    return dig, OS._encode(f, z), words


def present_tail_b(dig, fz, words, rank: int):
    """The first form's launch-B twin: every rank's tile words [M, K,
    T + 1]."""
    K, lloc = dig.shape
    M, _, T1 = words.shape
    T, G = T1 - 1, lloc // OS.SEG
    dev = dig.device
    tf, tz = OS._decode(words[:, :, :T].permute(1, 0, 2).reshape(K, M * T))
    ef, ez = OS._identity((K,), dev)
    pre_f, pre_z = [], []
    for g in range(M * T):
        pre_f.append(ef)
        pre_z.append(ez)
        ef, ez = OS._compose(tf[:, g], tz[:, g], ef, ez)
    top = words[M - 1, :, T].to(torch.int64)
    neg = top + ef[:, 1] < 0
    sign = torch.where(neg & ~ez[:, 1], -1, 1).to(torch.int32)
    bf = torch.stack(pre_f[rank * T:(rank + 1) * T], 1)
    bz = torch.stack(pre_z[rank * T:(rank + 1) * T], 1)
    sf, sz = OS._decode(fz)
    fi, zi = OS._identity((K, T * PRESENT_TILE_SEGS - G), dev)
    sf = torch.cat([sf, fi], 1).view(K, T, PRESENT_TILE_SEGS, 3)
    sz = torch.cat([sz, zi], 1).view(K, T, PRESENT_TILE_SEGS, 3)
    inf, inz = OS._scan(sf, sz)
    xf, xz = OS._identity((K, T, 1), dev)
    xf = torch.cat([xf, inf[:, :, :-1]], 2)
    xz = torch.cat([xz, inz[:, :, :-1]], 2)
    pf, pz = OS._compose(xf, xz, bf.unsqueeze(2).expand_as(xf),
                         bz.unsqueeze(2).expand_as(xz))
    cin = pf[..., 1].reshape(K, -1)[:, :G]
    zb = pz[..., 1].reshape(K, -1)[:, :G]
    d = dig.to(torch.int64).view(K, G, OS.SEG).clone()
    for q in range(OS.SEG):
        v = d[:, :, q] + cin
        d[:, :, q], cin = v & MASK, v >> 16
        nd = torch.where(zb, torch.where(d[:, :, q] == 0, 0,
                                         0x10000 - d[:, :, q]),
                         MASK - d[:, :, q])
        zb = zb & (d[:, :, q] == 0)
        d[:, :, q] = torch.where(neg.view(K, 1), nd, d[:, :, q])
    return d.reshape(K, lloc).to(torch.int32), sign


def _blocks(inv, cadd, rnd, cfg, M: int, zsign=None):
    """K20's twins over M blocks of the whole vector from their receive
    buffers, the words stacked by hand (no collective), beside the first form's
    twins after the plain reshard: (digits [K, L], each block's signs),
    asserting on the way that the two agree block by block."""
    K, _, L = inv.shape
    lloc, H = L // M, OS.HALO
    pad = torch.nn.functional.pad
    ip, cp, rp = pad(inv, (H, 0)), pad(cadd, (H, 0)), pad(rnd, (H, 0))
    lays, recvs = OS.receive_buffers(inv, M)
    new, old = [], []
    for r in range(M):
        rows = OS.unpack(recvs[r], lays[r])
        assert torch.equal(rows, ip[..., r * lloc:r * lloc + H + lloc])
        planes = (cp[:, r * lloc:r * lloc + H + lloc].contiguous(),
                  rp[r * lloc:r * lloc + H + lloc].contiguous())
        new.append(OS.tail_a_plain(recvs[r], *planes, cfg, lays[r], zsign))
        old.append(present_tail_a(rows, *planes, OS._cfg(cfg, zsign)))
        assert torch.equal(new[-1][0], old[-1][0])
    words = torch.stack([a[2] for a in new])
    owords = torch.stack([a[2] for a in old])
    fin = [OS.tail_b_plain(a[0], a[1], words, r) for r, a in enumerate(new)]
    for r, a in enumerate(old):
        od, osg = present_tail_b(a[0], a[1], owords, r)
        assert torch.equal(fin[r][0], od) and torch.equal(fin[r][1], osg)
    return torch.cat([f[0] for f in fin], 1), [f[1] for f in fin]


def _exact(s, cadd, rnd, cfg, L: int):
    """Python ints: digits and signs of the tail's function (sparse
    inputs: only their nonzero entries are visited)."""
    mags, signs = [], []
    for k in range(len(s)):
        dbl, gsw, cs = cfg[4 * k], cfg[4 * k + 1], cfg[4 * k + 2]
        tot = 0
        for j in np.nonzero(s[k])[0].tolist():
            v = int(s[k][j]) * (2 if dbl > 0 else 1) * (-1 if gsw < 0 else 1)
            for q in range(4):
                if j + q < L:
                    part = (abs(v) >> (16 * q)) & 0xFFFF
                    tot += (-part if v < 0 else part) << (16 * (j + q))
        for j in np.nonzero(cadd[k])[0].tolist():
            c = int(cadd[k][j])
            tot += (c if cs > 0 else -c) << (16 * j)
        for j in np.nonzero(rnd)[0].tolist():
            tot += int(rnd[j]) << (16 * j)
        mag = (-tot if tot < 0 else tot) % (1 << (16 * L))
        mags.append(np.frombuffer(mag.to_bytes(2 * L, "little"), "<u2"))
        signs.append(-1 if tot < 0 and mag else 1)
    return np.asarray(mags, np.int64), np.asarray(signs, np.int64)


_P1P2 = N.P1 * N.P2


def _residues(s: np.ndarray) -> torch.Tensor:
    rec = np.where(s < 0, s + _P1P2, s)
    return torch.from_numpy(np.stack([rec % N.P1, rec % N.P2], 1)
                            .astype(np.int32))


@st.composite
def _edge_case(draw):
    """A tail whose carries or borrows run across block edges: digit sums
    that are 0xFFFF or 0 over a stretch ending at or past an edge, with a
    coefficient just below the stretch that makes or takes a carry.
    Blocks of 16 to 2,048 digits (below one K20 tile of 512 and up to 4
    of them), M up to 16 ranks."""
    M = draw(st.sampled_from((2, 4, 8, 16)))
    L = M * draw(st.sampled_from((16, 32, 1024, 2048)))
    K = draw(st.integers(1, 3))
    s = np.zeros((K, L), np.int64)
    cadd = np.zeros((K, L), np.int64)
    rnd = np.zeros(L, np.int64)
    edge = (L // M) * draw(st.integers(1, M - 1))
    for k in range(K):
        lo = max(0, edge - draw(st.integers(1, 40)))
        hi = min(L, edge + draw(st.integers(0, 40)))
        cadd[k, lo:hi] = draw(st.sampled_from((0, 0xFFFF)))
        j = max(0, lo - draw(st.integers(1, 4)))
        s[k, j] = draw(st.integers(-(1 << 40), 1 << 40))
        for _ in range(draw(st.integers(0, 3))):
            s[k, draw(st.integers(0, L - 1))] = draw(
                st.integers(-(1 << 46), 1 << 46))
    if draw(st.booleans()):
        rnd[draw(st.integers(0, L - 1))] = 1 << 15
    cfg = []
    for _ in range(K):
        cfg += [draw(st.integers(0, 1)), draw(st.sampled_from((-1, 1))),
                draw(st.sampled_from((-1, 1))), 0]
    return M, s, cadd, rnd, cfg


def _whole_and_exact(M, s, cadd, rnd, cfg):
    L = s.shape[1]
    inv = _residues(s)
    ct = torch.from_numpy(cadd.astype(np.int32))
    rt = torch.from_numpy(rnd.astype(np.int32))
    dig, signs = _blocks(inv, ct, rt, cfg, M)
    wd, ws = NP.fused_tail_plain(inv, ct, rt, cfg)
    assert torch.equal(dig, wd)
    assert all(torch.equal(sg, ws) for sg in signs)
    ed, es = _exact(s, cadd, rnd, cfg, L)
    np.testing.assert_array_equal(dig.numpy(), ed)
    np.testing.assert_array_equal(ws.numpy(), es)
    return es


@settings(max_examples=60, deadline=None)
@given(_edge_case())
def test_k20_blocks_equal_the_whole_tail_and_python_ints(case):
    """K20's twins from the receive buffers, the carry-in given through
    the per-rank words, block by block = the first form's twins = the
    whole-vector tail (K10's twin) = Python ints, carries and borrows
    across block edges included."""
    _whole_and_exact(*case)


@pytest.mark.parametrize("M", (2, 4, 16))
def test_k20_negative_total_and_a_carry_across_ranks(M):
    """A negative total whose borrow, and a positive one whose carry,
    ripple from below a rank boundary across a run of 0xFFFF (0 for the
    borrow) digits into the next ranks: the twins block by block = the
    whole tail = Python ints."""
    L = M * 64
    edge = L // M
    s = np.zeros((2, L), np.int64)
    cadd = np.zeros((2, L), np.int64)
    cadd[0, edge - 5:edge + 70] = 0xFFFF       # + a carry of 1 from below
    s[0, edge - 9] = 1 << 20
    s[1, edge - 9] = -(1 << 20)                # a borrow through zeros
    s[1, L - 40] = -(1 << 30)                  # and a negative total
    cfg = [0, 1, 1, 0, 0, 1, 1, 0]
    signs = _whole_and_exact(M, s, cadd, np.zeros(L, np.int64), cfg)
    assert list(signs) == [1, -1]


@pytest.mark.parametrize("M", (1, 2, 4, 8, 16))
def test_k20_blocks_on_a_step(M):
    """A step's residue rows at 512 limbs (the 0xFFFF-run centre; nfft
    2,048: 32 × 64, so 16 ranks leave 4 columns a rank and the halo spans
    two), cut into M blocks and packed as the reshard sends them: the
    receive buffer read in torch = the rows' slices, and K20's twins =
    the first form's twins after the plain reshard = the whole-vector
    tail, digits and signs, with the component 1's sign from zsign too."""
    spec, scx, cxd, scy, cyd = _coords(*COORDS[1], 512)
    x, y = (torch.from_numpy(d.astype(np.int32)) for d in (cxd, cyd))
    inv = NP.products(torch.stack([x, y]), None, spec.nfft, NP.PLAN_ITER)
    cadd, rnd = FP.addend_planes(x, y, spec)
    cfg = NP.tail_cfg((scx, scy, scx * scy, 0), nr=False)
    wd, ws = NP.fused_tail_plain(inv, cadd, rnd, cfg)
    for zsign in (None, torch.tensor([scx, scy], dtype=torch.int32)):
        c = cfg if zsign is None else NP.tail_cfg((scx, scy, 1, 0), False)
        dig, signs = _blocks(inv, cadd, rnd, c, M, zsign)
        assert torch.equal(dig, wd)
        assert all(torch.equal(sg, ws) for sg in signs)


def test_refusals():
    """Refused before any collective: a spec without the flat layout, a
    mesh that does not divide the four-step factors; K20's block shapes.
    A mesh with fewer than 8 columns a rank is taken."""
    cpu = torch.device("cpu")
    spec = FP.FixedSpec(digits=100, nfft=256)
    z = torch.zeros(100, dtype=torch.int32)
    with pytest.raises(ValueError, match="2·D == nfft"):
        OS.iterate_z_sharded(1, z, 1, z, 1, z, 1, z, spec=spec,
                             mesh=Mesh(None, 2, 0, cpu))
    spec = FP.FixedSpec.for_limbs(512)
    z = torch.zeros(spec.digits, dtype=torch.int32)
    with pytest.raises(ValueError, match="divide both"):
        OS.iterate_z_sharded(1, z, 1, z, 1, z, 1, z, spec=spec,
                             mesh=Mesh(None, 3, 0, cpu))
    # 16 ranks leave 4 columns a rank: taken (the halo spans two ranks;
    # test_orbit_chunk_sharded_on_narrow_meshes runs it)
    assert OS.check_spec(spec, Mesh(None, 16, 0, cpu)) == \
        N.split_n(spec.nfft)
    lay = OS.Layout(4, 4, 2, 1)
    with pytest.raises(ValueError, match="K20"):
        OS.tail_a(torch.zeros(2, lay.slot + 1, dtype=torch.int32),
                  torch.zeros(2, 16, dtype=torch.int32),
                  torch.zeros(16, dtype=torch.int32), [0] * 8, lay)
    with pytest.raises(ValueError, match="K20"):
        OS.tail_a(torch.zeros(2, lay.slot, dtype=torch.int32),
                  torch.zeros(2, 16, dtype=torch.int32),
                  torch.zeros(16, dtype=torch.int32), [0] * 8,
                  OS.Layout(4, 4, 2, 2))
    with pytest.raises(ValueError, match="K20 launch B"):
        OS.tail_b(torch.zeros(2, 8, dtype=torch.int32),
                  torch.zeros(2, 2, dtype=torch.int32),
                  torch.zeros(3, 2, 2, dtype=torch.int32), lay)


@pytest.mark.cuda
@pytest.mark.parametrize("M", (1, 2, 4, 8, 16))
def test_k20_equals_its_twins_on_card(M):
    """K20's two launches on the card = their twins, block by block, from
    the receive buffers (a step's residue rows at 512 limbs, the
    0xFFFF-run centre, and rows with carries and borrows across the
    edges), with and without zsign read on the card; launch B in place;
    the blocks = the whole tail."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec, scx, cxd, scy, cyd = _coords(*COORDS[1], 512)
    x, y = (torch.from_numpy(d.astype(np.int32)) for d in (cxd, cyd))
    inv = NP.products(torch.stack([x, y]), None, spec.nfft, NP.PLAN_ITER)
    cadd, rnd = FP.addend_planes(x, y, spec)
    rng = np.random.default_rng(M)
    s = np.zeros((2, spec.nfft), np.int64)
    s[:, rng.integers(0, spec.nfft, 6)] = rng.integers(-(1 << 44), 1 << 44,
                                                       6)
    edge = spec.nfft // max(M, 2)
    runs = torch.zeros_like(cadd)
    runs[:, edge - 20:edge + 9] = 0xFFFF
    L, H = spec.nfft, OS.HALO
    lloc = L // M
    pad = torch.nn.functional.pad
    for inv_, cadd_, zs in ((inv, cadd, None), (_residues(s), runs, (1, -1))):
        cfg = NP.tail_cfg((scx, scy, scx * scy, 0), nr=False)
        zsign = None if zs is None else torch.tensor(zs, dtype=torch.int32)
        lays, recvs = OS.receive_buffers(inv_, M)
        cp, rp = pad(cadd_, (H, 0)), pad(rnd, (H, 0))
        planes = [(cp[:, r * lloc:r * lloc + H + lloc].contiguous(),
                   rp[r * lloc:r * lloc + H + lloc].contiguous())
                  for r in range(M)]
        want = [OS.tail_a_plain(recvs[r], *planes[r], cfg, lays[r], zsign)
                for r in range(M)]
        got = [OS.tail_a(recvs[r].cuda(), *(t.cuda() for t in planes[r]),
                         cfg, lays[r],
                         None if zsign is None else zsign.cuda())
               for r in range(M)]
        for g, w in zip(got, want):
            for gi, wi in zip(g, w):
                assert torch.equal(gi.cpu(), wi)
        words = torch.stack([w[2] for w in want])
        fin = []
        for r in range(M):
            gd, gs = OS.tail_b(got[r][0], got[r][1], words.cuda(), lays[r])
            assert gd.data_ptr() == got[r][0].data_ptr()
            wd, ws = OS.tail_b_plain(want[r][0], want[r][1], words, r)
            assert torch.equal(gd.cpu(), wd) and torch.equal(gs.cpu(), ws)
            fin.append(wd)
        whole = NP.fused_tail_plain(inv_, cadd_, rnd, OS._cfg(cfg, zsign))
        assert torch.equal(torch.cat(fin, 1), whole[0])
