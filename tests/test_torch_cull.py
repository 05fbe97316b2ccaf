"""PyTorch port: the per-tile culled sweep (`accel/cull.py`, `ops/cull_sweep.py`)
against the JAX reference's `accel/cull.py` and against the port's grid walk.

The scene is tests/test_cull.py's: the bumpy sphere (subdiv 3) in config4
at 96×64 d3, tiles of 1536 rays. Standards: build arrays bit-equal; list
ids and counts, and the audit's counts, exact; the plain sweep against the
reference's dense sweep at t rtol 2e-6 with ids and occlusion exact; the
culled render against the port's grid render to 2e-7 max |Δ| (the
reference's own standard) and against the JAX culled render at
tests/test_torch_render.py's per-pixel standard; gradients at loss rtol
1e-6, gradients rtol 1e-4, atol 1e-7.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.accel import cull as RC
from raytracer_tpu.accel.grid import GridTracer as RefGridTracer
from raytracer_tpu.renderer import render as ref_render
from raytracer_tpu_torch.accel import cull as C
from raytracer_tpu_torch.accel.grid import GridTracer
from raytracer_tpu_torch.kernels.build import warp_work
from raytracer_tpu_torch.ops import cull_sweep as CS
from raytracer_tpu_torch.renderer import render, value_and_grad_banded
from tests.helpers import assert_images_close
from tests.torch_cases import bumpy_config4, port

torch.set_num_threads(2)

CAP = 1280       # no list overflows (tests/test_cull.py)
SMALL_CAP = 128  # lists overflow
IMG_MAX = 2e-7


def _with_params(scene, p):
    return scene.replace(
        spheres=dataclasses.replace(scene.spheres, center=p["center"]),
        materials=dataclasses.replace(scene.materials, albedo=p["albedo"]))


@pytest.fixture(scope="module")
def case():
    """tests/test_cull.py's mesh_scene, both packages' grid tracers, the
    JAX culled render and the JAX audit (its counts do not depend on cap)."""
    scene, cam, opts = bumpy_config4(3, 96, 64)
    opts = dataclasses.replace(opts, max_depth=3, tile_rays=1536,
                               tile_block=(16, 96))
    rg = RefGridTracer.build(scene)
    ref_img = np.asarray(ref_render(
        scene, cam, opts, tracer=RC.CullTracer.build(scene, cap=CAP,
                                                     inner=rg))[0])
    audit = RC.cull_audit(scene, cam, opts, cap=CAP, inner=rg)
    ps, pc, po = port(scene, cam, opts)
    grid = GridTracer.build(ps, "cpu")
    grid_img = render(ps, pc, po, device="cpu", tracer=grid)[0]
    return dict(scene=scene, cam=cam, opts=opts, rg=rg, ref_img=ref_img,
                audit=audit, ps=ps, pc=pc, po=po, grid=grid,
                grid_img=grid_img)


def _primary_tiles(c):
    """The band's primary rays in render's tiles → (orig [k·tile, 3], dirs
    [k·tile, 3], k, tile), CPU tensors."""
    _, dirs, orig, _, tile, _, _ = C._band_tiles(c["ps"], c["pc"], c["po"],
                                                 0, None, "cpu")
    k = dirs.shape[0]
    return orig.repeat(k, 1), dirs.reshape(-1, 3), k, tile


@pytest.mark.parametrize("cap,chunk,want_cap", [(CAP, 128, CAP),
                                                (200, 128, 256)])
def test_build_cull_matches_reference(case, cap, chunk, want_cap):
    want = RC.build_cull(case["scene"], cap, chunk)
    got = C.build_cull(case["ps"], "cpu", cap, chunk)
    assert got.cap == want.cap == want_cap
    assert got.n_tris == want.n_tris and got.chunk == chunk
    for name in ("soa", "tri_lo", "tri_hi", "bmin", "bmax"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    rows = got.rows.numpy()
    assert rows.shape == (got.n_tris + 1, 12)
    np.testing.assert_array_equal(rows[:, 9], np.arange(got.n_tris + 1))
    assert not rows[:, 10:].any() and not rows[-1, :9].any()


# the lists of the band's 4 primary tiles (counts 0, 297, 962, 379) and one
# list with no lane inside: at cap 379 (chunk 1) tile 3's list is exactly
# full and tile 2's overflows; at 128 three overflow; at 1280 none
@pytest.mark.parametrize("cap", [379, SMALL_CAP, CAP])
def test_tile_ids_batched_matches_reference_per_tile(case, cap):
    cd = C.build_cull(case["ps"], "cpu", cap, 1)
    rcd = RC.build_cull(case["scene"], cap, 1)
    orig, dirs, k, tile = _primary_tiles(case)
    # list k: tile 0's rays with no lane inside
    orig = torch.cat([orig, orig[:tile]])
    dirs = torch.cat([dirs, dirs[:tile]])
    active = torch.arange(orig.shape[0]) < k * tile
    lo, hi, inside = C._segments(cd, orig, dirs, case["po"].t_min,
                                 active=active)
    lo, hi = lo.reshape(k + 1, tile, 3), hi.reshape(k + 1, tile, 3)
    inside = inside.reshape(k + 1, tile)
    ids, counts = C.tile_ids(cd, lo, hi, inside)
    assert ids.dtype == counts.dtype == torch.int32
    want_counts = []
    for j in range(k + 1):
        s = slice(j * tile, (j + 1) * tile)
        rl, rh, ri = RC._segments(rcd, jnp.asarray(orig[s].numpy()),
                                  jnp.asarray(dirs[s].numpy()),
                                  case["po"].t_min,
                                  active=jnp.asarray(active[s].numpy()))
        np.testing.assert_array_equal(lo[j].numpy(), np.asarray(rl))
        np.testing.assert_array_equal(hi[j].numpy(), np.asarray(rh))
        np.testing.assert_array_equal(inside[j].numpy(), np.asarray(ri))
        w_ids, w_count = RC.tile_ids(rcd, rl, rh, ri)
        np.testing.assert_array_equal(ids[j].numpy(), np.asarray(w_ids))
        want_counts.append(int(w_count))
    assert counts.tolist() == want_counts
    assert want_counts[0] == want_counts[k] == 0
    assert (ids[0] == cd.n_tris).all()
    if cap == 379:
        assert want_counts[3] == cap < want_counts[2]


def _shadow_rays(case):
    """Tile-ordered d0 shadow rays toward light 0 from the grid's d0 hits
    (the audit's construction) → (orig, dirs, max_t, active)."""
    orig, dirs, _, _ = _primary_tiles(case)
    hit = case["grid"].nearest(orig, dirs, case["po"].t_min, 1024)
    valid = torch.isfinite(hit.t)
    p = orig + torch.where(valid, hit.t, 0.0)[:, None] * dirs
    lvec = case["ps"].to("cpu").lights.pos[0][None, :] - p
    dist = torch.linalg.vector_norm(lvec, dim=1)
    return p, lvec / dist[:, None], dist, valid


@pytest.mark.parametrize("cap", [CAP, SMALL_CAP])
@pytest.mark.parametrize("mode", ["nearest", "occluded"])
def test_plain_sweep_matches_reference_dense(case, mode, cap):
    """The plain sweep against `_dense_nearest` / `_dense_occluded`, list
    by list (the truncating cap too): t rtol 2e-6, ids exact on the lanes
    inside the box (a lane outside misses with id n_tris here, with its
    list's lowest id in the reference: only hits' ids are read), occlusion
    exact."""
    cd = C.build_cull(case["ps"], "cpu", cap)
    rcd = RC.build_cull(case["scene"], cap)
    orig, dirs, k, tile = _primary_tiles(case)
    t_min = case["po"].t_min
    max_t, active = None, None
    if mode == "occluded":
        orig, dirs, max_t, active = _shadow_rays(case)
    lo, hi, inside = C._segments(cd, orig, dirs, t_min, max_t, active)
    ids, counts = C.tile_ids(cd, lo.reshape(k, tile, 3),
                             hi.reshape(k, tile, 3), inside.reshape(k, tile))
    got = CS.cull_sweep_plain((orig, dirs), ids, counts, cd.rows, tile, t_min,
                              inside, max_t)
    n_hits = 0
    for j in range(k):
        s = slice(j * tile, (j + 1) * tile)
        args = (rcd, jnp.asarray(orig[s].numpy()), jnp.asarray(dirs[s].numpy()),
                t_min)
        if mode == "occluded":
            want = RC._dense_occluded(*args, jnp.asarray(max_t[s].numpy()),
                                      jnp.asarray(ids[j].numpy()),
                                      jnp.asarray(inside[s].numpy()))
            np.testing.assert_array_equal(got[s].numpy(), np.asarray(want))
            n_hits += int(np.asarray(want).sum())
            continue
        wt, wi = RC._dense_nearest(*args, jnp.asarray(ids[j].numpy()),
                                   jnp.asarray(inside[s].numpy()))
        wt, wi = np.asarray(wt), np.asarray(wi)
        np.testing.assert_allclose(got[0][s].numpy(), wt, rtol=2e-6)
        ins = inside[s].numpy()
        np.testing.assert_array_equal(got[1][s].numpy()[ins], wi[ins])
        assert (got[1][s].numpy()[~ins] == cd.n_tris).all()
        n_hits += int(np.isfinite(wt).sum())
    assert n_hits > 0


@pytest.mark.parametrize("depths,block", [((0,), (16, 96)),
                                          ((0, 1, 2, 3), None)])
def test_culled_render_matches_grid(case, depths, block):
    """Non-overflowing cap ⇒ culled == grid to 1 ulp, at d0 only (screen
    blocks) and at every depth (flat tiles: the cursor maps calls to depths
    beyond d0)."""
    opts = dataclasses.replace(case["po"], tile_block=block)
    tr = C.CullTracer(case["ps"], "cpu", inner=case["grid"], cap=CAP,
                      cull_depths=depths)
    img, _ = render(case["ps"], case["pc"], opts, device="cpu", tracer=tr)
    assert float((img - case["grid_img"]).abs().max()) <= IMG_MAX


def test_culled_render_matches_jax_culled_render(case):
    tr = C.CullTracer(case["ps"], "cpu", inner=case["grid"], cap=CAP)
    img, _ = render(case["ps"], case["pc"], case["po"], device="cpu",
                    tracer=tr)
    assert_images_close(img.numpy(), case["ref_img"], tol=1e-4,
                        max_bad_frac=0.004, name="culled config4-subdiv3")


@pytest.mark.parametrize("cap", [CAP, SMALL_CAP])
def test_cull_audit_matches_reference(case, cap):
    got = C.cull_audit(case["ps"], case["pc"], case["po"], device="cpu",
                       cap=cap, inner=case["grid"])
    want = case["audit"] if cap == CAP else RC.cull_audit(
        case["scene"], case["cam"], case["opts"], cap=cap, inner=case["rg"])
    for key in ("d0", "shadow"):
        np.testing.assert_array_equal(got[key], want[key], key)
    for key in ("cap", "n_tris", "tile", "n_tiles"):
        assert got[key] == want[key], key
    assert got["shadow"].shape == (4, 2)
    over = max(got["d0"].max(), got["shadow"].max()) > cap
    assert over == (cap == SMALL_CAP)


def test_cull_overflow_diverges_from_grid(case):
    """A cap the lists overflow truncates them: the audit reports it (above)
    and the render visibly diverges — why the gate is needed."""
    tr = C.CullTracer(case["ps"], "cpu", inner=case["grid"], cap=SMALL_CAP)
    img, _ = render(case["ps"], case["pc"], case["po"], device="cpu",
                    tracer=tr)
    assert float((img - case["grid_img"]).abs().max()) > 1e-3


@pytest.fixture(scope="module")
def grad_case(case):
    """tests/test_cull.py::test_cull_gradients_match_grid's setting: 48×32
    d2, tiles of 512 in 8×64 blocks, loss Σ img² (here / (H·W·3), the mean
    that value_and_grad_banded takes against a zero target). The JAX
    values are run op by op (XLA:CPU contracts multiply-adds in jitted
    code: tests/test_torch_grads.py)."""
    scene, cam = case["scene"], case["cam"]
    opts = dataclasses.replace(case["opts"], width=48, height=32, max_depth=2,
                               tile_rays=512, tile_block=(8, 64))
    p0 = {"center": np.asarray(scene.spheres.center),
          "albedo": np.asarray(scene.materials.albedo)}
    denom = np.float32(48 * 32 * 3)

    def loss(p):
        sc = _with_params(scene, p)
        img = ref_render(sc, cam, opts, tracer=RC.CullTracer.build(
            scene, cap=CAP, inner=case["rg"]))[0]
        return jnp.sum(img ** 2) / denom

    with jax.disable_jit():
        jv, jg = jax.value_and_grad(loss)(
            {k: jnp.asarray(v) for k, v in p0.items()})
    ps, pc, po = port(scene, cam, opts)
    target = np.zeros((32, 48, 3), np.float32)
    gv, gg = value_and_grad_banded(_with_params, p0, ps, pc, po, target,
                                   device="cpu", tracer=case["grid"])
    return dict(jv=float(jv), jg={k: np.asarray(v) for k, v in jg.items()},
                gv=gv, gg=gg, p0=p0, ps=ps, pc=pc, po=po, target=target)


def _assert_vg_close(v, g, want_v, want_g, loss_rtol=1e-6):
    np.testing.assert_allclose(float(v), float(want_v), rtol=loss_rtol)
    for k in want_g:
        np.testing.assert_allclose(np.asarray(g[k]), np.asarray(want_g[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("policy", ["plan", "full"])
def test_cull_gradients_match_grid_and_jax(case, grad_case, policy):
    """value_and_grad through the culled tracer == through the grid tracer
    and == the JAX culled tracer's, under both remat policies: the winner
    ids are the grid's (superset lists), and each remat path's search or
    recompute calls render_rays, which resets the cursor."""
    gc = grad_case
    opts = dataclasses.replace(gc["po"], remat_policy=policy)
    tr = C.CullTracer(gc["ps"], "cpu", inner=case["grid"], cap=CAP)
    v, g = value_and_grad_banded(_with_params, gc["p0"], gc["ps"], gc["pc"],
                                 opts, gc["target"], device="cpu", tracer=tr)
    _assert_vg_close(v, g, gc["gv"], gc["gg"])
    # jnp's f32 sum of the same image's 4,608 squares is 4.6e-6 off
    # torch's (and off the f64 sum): the loss at the cross-package rtol of
    # tests/test_torch_grads.py
    _assert_vg_close(v, g, gc["jv"], gc["jg"], loss_rtol=1e-5)


def test_render_partitioned_matches_jax(case):
    """The hybrid at cap 1024 (tiles 0–1 thin, 2–3 fat): the audit's counts
    and partition equal the JAX package's, the image its culled render's
    (which its own render_partitioned equals to 6e-8) and the port's grid
    render; HybridBand's frame equals render_partitioned's bit for bit."""
    cap = 1024
    out = {}
    img, traced = C.render_partitioned(case["ps"], case["pc"], case["po"],
                                       device="cpu", inner=case["grid"],
                                       cap=cap, count_rays=True,
                                       counts_out=out)
    a = case["audit"]
    np.testing.assert_array_equal(out["d0"], a["d0"])
    np.testing.assert_array_equal(out["shadow"], a["shadow"].max(axis=1))
    want_thin = (a["d0"] <= cap) & (a["shadow"].max(axis=1) <= cap)
    np.testing.assert_array_equal(out["thin"], want_thin)
    assert 0 < want_thin.sum() < want_thin.size
    assert_images_close(img.numpy(), case["ref_img"], tol=1e-4,
                        max_bad_frac=0.004, name="partitioned")
    assert float((img - case["grid_img"]).abs().max()) <= IMG_MAX
    _, want_traced = render(case["ps"], case["pc"], case["po"], device="cpu",
                            tracer=case["grid"], count_rays=True)
    assert float(traced) == float(want_traced)
    band = C.HybridBand(case["ps"], case["pc"], case["po"], device="cpu",
                        inner=case["grid"], cap=cap)
    assert (band.n_thin, band.n_tiles) == (int(want_thin.sum()), 4)
    assert torch.equal(band(), img)


def test_hybrid_image_gradients_match_grid(case, grad_case):
    gc = grad_case
    band = C.HybridBand(gc["ps"], gc["pc"], gc["po"], device="cpu",
                        inner=case["grid"], cap=1024)
    assert 0 < band.n_thin < band.n_tiles

    def band_fn(leaves, r0, rb):
        return band.image(scene=_with_params(band.scene, leaves))[0]

    from raytracer_tpu_torch.renderer import value_and_grad_bands

    v, g = value_and_grad_bands(band_fn, gc["p0"], gc["po"], gc["target"],
                                [(0, 32)], device="cpu")
    _assert_vg_close(v, g, gc["gv"], gc["gg"])


def test_render_rays_resets_the_cursor(case, monkeypatch):
    """Every render_rays call gets a fresh cursor: each of the 4 tiles
    culls its d0 call, and the remat recompute ("full") culls again. Without
    the reset only the first call would see depth 0."""
    calls = []
    real = CS.cull_nearest

    def spy(*args):
        calls.append(args[0][0].shape[0])
        return real(*args)

    monkeypatch.setattr(CS, "cull_nearest", spy)
    tr = C.CullTracer(case["ps"], "cpu", inner=case["grid"], cap=CAP)
    render(case["ps"], case["pc"], case["po"], device="cpu", tracer=tr)
    render(case["ps"], case["pc"], case["po"], device="cpu", tracer=tr)
    assert calls == [1536] * 8
    calls.clear()
    opts = dataclasses.replace(case["po"], remat_policy="full")
    leaf = {"albedo": case["ps"].materials.albedo}
    value_and_grad_banded(
        lambda s, p: s.replace(materials=dataclasses.replace(
            s.materials, albedo=p["albedo"])), leaf, case["ps"], case["pc"],
        opts, case["grid_img"], device="cpu", tracer=tr)
    assert calls == [1536] * 8  # 4 tiles, forward and recompute


def test_culled_call_must_be_whole_lists(case):
    tr = C.CullTracer(case["ps"], "cpu", inner=case["grid"], tile=512)
    orig, dirs, _, _ = _primary_tiles(case)
    with pytest.raises(ValueError, match="whole lists"):
        tr.fresh().nearest(orig[:700], dirs[:700], 1e-4, 1024)
    hit = tr.fresh().nearest(orig[:1024], dirs[:1024], 1e-4, 1024)
    want = case["grid"].nearest(orig[:1024], dirs[:1024], 1e-4, 1024)
    assert torch.equal(hit.t, want.t) and torch.equal(hit.kind, want.kind)


def _sweep_inputs(case, mode, cap):
    """The band's primaries (or one light's shadow rays) in render's tiles,
    culled at `cap` → (rays, ids, counts, table, tile, t_min, inside,
    max_t), the sweep's arguments."""
    cd = C.build_cull(case["ps"], "cpu", cap)
    orig, dirs, k, tile = _primary_tiles(case)
    t_min = case["po"].t_min
    max_t, active = None, None
    if mode == "occluded":
        orig, dirs, max_t, active = _shadow_rays(case)
    lo, hi, inside = C._segments(cd, orig, dirs, t_min, max_t, active)
    ids, counts = C.tile_ids(cd, lo.reshape(k, tile, 3),
                             hi.reshape(k, tile, 3), inside.reshape(k, tile))
    return (orig, dirs), ids, counts, cd.rows, tile, t_min, inside, max_t


@pytest.mark.parametrize("mode", ["nearest", "occluded"])
@pytest.mark.parametrize("order", ["lanes", "live"])
def test_plain_sweep_warp_tests(case, mode, order):
    """The sweep's counters against a loop over lanes (a cap that lists
    overflow): tests = Σ min(count, cap) over live lanes, `lane_tests` each
    lane's, and `warp_work` of them in a slot order (each list's lanes, or
    its live lanes in order, a row per list) = Σ over groups of 32 slots of
    each list of 32 × the group's most tests. Passing `stats` leaves the
    outputs bit-equal."""
    args = _sweep_inputs(case, mode, SMALL_CAP)
    stats = {}
    got = CS.cull_sweep_plain(*args, stats=stats)
    want = CS.cull_sweep_plain(*args)
    if mode == "occluded":
        assert torch.equal(got, want)
    else:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ids, counts, tile, inside = args[1], args[2], args[4], args[6]
    lens = np.minimum(counts.numpy(), ids.shape[1])
    ins = inside.numpy().reshape(-1, tile)
    tests = warp = 0
    lane_tests, rows = [], []
    for j in range(ins.shape[0]):
        per = [int(lens[j]) if a else 0 for a in ins[j]]
        tests += sum(per)
        lane_tests += per
        slots = per if order == "lanes" else [
            p for p, a in zip(per, ins[j]) if a]
        rows.append(slots + [0] * (tile - len(slots)))
        for g in range(0, len(slots), 32):
            warp += 32 * max(slots[g:g + 32])
    assert stats["lane_tests"].tolist() == lane_tests
    assert stats["tests"] == tests
    per_lane = (stats["lane_tests"].reshape(-1, tile) if order == "lanes"
                else torch.tensor(rows))
    assert warp_work(per_lane) == warp
    assert warp > tests > 0
    assert int((counts > SMALL_CAP).sum()) > 0  # overflowing lists count cap


def _np_shares(act, counts, tile, per_cta):
    """numpy: each list's live lanes, the kernel's list of them (each at
    the front of its list's segment, the rest N), their counts, and the CTA
    table (first, count) of the kernel's launch."""
    act = act.reshape(-1, tile)
    n = act.size
    lanes = [np.nonzero(a)[0] + j * tile for j, a in enumerate(act)]
    sizes = np.array([len(x) for x in lanes])
    live = np.full(n, n, np.int64)
    for j, x in enumerate(lanes):
        live[j * tile:j * tile + len(x)] = x
    nb = -(-tile // per_cta)
    table = np.zeros((act.shape[0], nb, 2), np.int64)
    for j in range(act.shape[0]):
        for b in range(nb):
            k = min(per_cta, sizes[j] - b * per_cta)
            table[j, b] = (j * tile + b * per_cta,
                           max(0, k) if counts[j] > 0 else 0)
    return lanes, live, sizes, table


@pytest.mark.parametrize("shape", ["dead_and_empty", "exactly_L", "ragged",
                                   "padded_row"])
def test_sweep_live_lists_and_cta_table(case, shape):
    """`list_live`'s list and counts (the list kernel's) and `cta_shares`'
    table against numpy; every CTA of the table takes its
    list's live lanes in order, and together the CTAs take every live lane
    of every non-empty list once. Cases: lists with no live lane and lists
    with no candidate, a list of exactly L live lanes, a tile that is not a
    multiple of L, and render's padded block row."""
    per_cta = CS.THREADS
    rng = np.random.default_rng(5)
    if shape == "padded_row":
        # 64 rows in blocks of 24: the last block row is padded with the
        # dummy direction
        opts = dataclasses.replace(case["po"], tile_block=(24, 96),
                                   tile_rays=24 * 96)
        cd = C.build_cull(case["ps"], "cpu", CAP)
        _, dirs, orig, _, tile, n_pix, _ = C._band_tiles(
            case["ps"], case["pc"], opts, 0, None, "cpu")
        k = dirs.shape[0]
        assert k * tile > n_pix
        o, d = orig.repeat(k, 1), dirs.reshape(-1, 3)
        lo, hi, inside = C._segments(cd, o, d, opts.t_min)
        _, counts = C.tile_ids(cd, lo.reshape(k, tile, 3),
                               hi.reshape(k, tile, 3),
                               inside.reshape(k, tile))
        act = inside.numpy()
    else:
        tile = {"dead_and_empty": 600, "exactly_L": 2 * per_cta,
                "ragged": per_cta + 77}[shape]
        act = rng.random((6, tile)) < 0.4
        counts = np.array([5, 0, 3, 7, 0, 9], np.int32)
        if shape == "dead_and_empty":
            act[2] = False   # no live lane, candidates
            act[1] = True    # live lanes, no candidate
        elif shape == "exactly_L":
            act[3] = False
            act[3, rng.permutation(tile)[:per_cta]] = True
        act = act.reshape(-1)
        counts = torch.from_numpy(counts)
    lanes, want_live, sizes, table = _np_shares(act, counts.numpy(), tile,
                                                per_cta)
    n_lists = len(lanes)
    live, got_n = CS.list_live(torch.from_numpy(act), n_lists, tile)
    got = CS.cta_shares(got_n, counts, tile, per_cta)
    np.testing.assert_array_equal(live.numpy(), want_live)
    np.testing.assert_array_equal(got_n.numpy(), sizes)
    np.testing.assert_array_equal(got.numpy(), table)
    taken = []
    for j in range(n_lists):
        for b, (first, n) in enumerate(got[j].tolist()):
            mine = live[first:first + n].numpy()
            np.testing.assert_array_equal(
                mine, lanes[j][b * per_cta:b * per_cta + n])
            taken.append(mine)
    busy = [x for j, x in enumerate(lanes) if int(counts[j]) > 0]
    np.testing.assert_array_equal(np.sort(np.concatenate(taken)),
                                  np.sort(np.concatenate(busy)))
    if shape == "exactly_L":
        assert sizes[3] == per_cta and table[3, 0, 1] == per_cta
        assert table[3, 1, 1] == 0
