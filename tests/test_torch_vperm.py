"""Port parity: photon_tpu_torch.ops.vperm (and ops/clos.py, native/) against
photon_tpu.ops.vperm.

The host router is a copy of the reference's, so the route planes both
packages build for one permutation must be equal array for array.  The
passes are pure data movement, so the port's plain passes (what CPU tensors
take in place of the K4/K5/K6 kernels) must equal the JAX passes, run in
interpret mode, bit for bit, and equal ``x[perm]``.  Every colored chunk
holds at least 2^18 elements, past the Python router's cap: these tests
build the native router (g++) as the port does at first use.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.ops import vperm as jv
from photon_tpu.ops.clos import _edge_color_python as jax_edge_color_python
from photon_tpu_torch.native import build as native_build
from photon_tpu_torch.ops import clos as tc
from photon_tpu_torch.ops import slab_reduce as tg
from photon_tpu_torch.ops import vperm as tv

CS = tv.CH_SMALL * tv.LANES
COLORED_PLANES = ("i1", "i2", "i3", "c", "i4", "i5", "i6")
BALANCED_PLANES = ("a1", "a2", "a3", "b1", "b2", "b3")


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch):
    monkeypatch.setenv("PHOTON_ROUTE_CACHE", "0")  # the JAX side's disk cache
    monkeypatch.delenv("PHOTON_XCHG_REDUCE", raising=False)
    monkeypatch.delenv("PHOTON_XCHG_DTYPE", raising=False)


def _same_planes(port, ref, names, meta):
    for name in meta:
        assert getattr(port, name) == getattr(ref, name), name
    for name in names:
        p, r = getattr(port, name), getattr(ref, name)
        if r is None:
            assert p is None, name
            continue
        r = np.asarray(r)
        assert p.numpy().dtype == r.dtype, name
        np.testing.assert_array_equal(p.numpy(), r, err_msg=name)


def _jax(a):
    return jnp.asarray(np.asarray(a))


@pytest.mark.parametrize("n,nc", [(CS - 12345, 1), (3 * CS - 777, 4)],
                         ids=["one_chunk", "four_chunks_padded"])
def test_colored_route_planes_and_passes_match_jax(n, nc):
    rng = np.random.default_rng(nc)
    perm = rng.permutation(n).astype(np.int64)
    x = rng.standard_normal(n).astype(np.float32)
    route = tv.route_vperm(perm, device="cpu")
    ref = jv.route_vperm(perm)
    assert route.nc == nc
    _same_planes(route, ref, COLORED_PLANES, ("n_in", "n_out", "nc", "ch"))
    got = tv.apply_vperm(torch.as_tensor(x), route).numpy()
    want = np.asarray(jv.apply_vperm(_jax(x), ref, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tv.apply_vperm_reference(x, perm))
    # The inverse route: the same planes as the reference's, and a round trip.
    inv = tv.invert_vperm(route)
    _same_planes(inv, jv.invert_vperm(ref), COLORED_PLANES, ("n_in", "n_out"))
    np.testing.assert_array_equal(
        tv.apply_vperm(torch.as_tensor(got), inv).numpy(), x
    )
    assert (tv.chunk_pass.launches, tv.lane_pass.launches) == (0, 0)


def _balanced_case(n, k, d, zipf, seed):
    rng = np.random.default_rng(seed)
    if zipf:
        ids = ((rng.zipf(1.3, size=(n, k)) - 1) % d).astype(np.int32)
    else:
        ids = rng.integers(0, d, size=(n, k), dtype=np.int32)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    vals[rng.random((n, k)) < 0.15] = 0.0
    return ids, vals, tg.build_aligned_layout(ids, vals, d)


@pytest.mark.parametrize("k,n", [(32, 8200), (4, 2048)], ids=["k32_nc2", "k4_nc1"])
@pytest.mark.parametrize("dist", ["uniform", "zipf"])
def test_balanced_aligned_route_matches_jax(dist, k, n):
    ids, vals, layout = _balanced_case(n, k, 512, dist == "zipf", seed=k)
    ref = jv.build_xchg_aux(layout, ids, 512, vals=vals)
    aux = tv.build_xchg_aux(layout, ids, vals=vals, device="cpu")
    assert isinstance(aux.route, tv.BalancedRoute)
    assert aux.route.k_expand == k and aux.route.nc == (2 if n == 8200 else 1)
    _same_planes(aux.route, ref.route, BALANCED_PLANES, (
        "n_in", "n_out", "nc", "ch", "blk", "cs_win", "ds_win", "k_expand"))
    # The bake (K4 stage A, block transpose, stage B) and the fingerprint.
    np.testing.assert_array_equal(aux.vals_dest.numpy(), np.asarray(ref.vals_dest))
    np.testing.assert_array_equal(aux.vals_fp, np.asarray(ref.vals_fp))
    # The exchange of a row-major product stream (zero where val == 0, the
    # entries the layout drops): every slot reads its source entry, every
    # pad slot a zero.
    rng = np.random.default_rng(9)
    x = rng.standard_normal(n * k).astype(np.float32) * (vals.reshape(-1) != 0)
    got = tv.apply_balanced(torch.as_tensor(x), aux.route).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jv.apply_balanced(_jax(x), ref.route, interpret=True)))
    r = aux.route
    slots = got.reshape(r.nc, r.cs)[:, :r.ds_win].reshape(-1)[:r.n_out]
    src = layout.src.reshape(-1)
    np.testing.assert_array_equal(slots, np.where(src >= 0, x[src], 0.0))
    # K6: dz expanded inside stage A.
    dz = rng.standard_normal(n).astype(np.float32)
    np.testing.assert_array_equal(
        tv.apply_balanced_dz(torch.as_tensor(dz), r).numpy(),
        np.asarray(jv.apply_balanced_dz(_jax(dz), ref.route, interpret=True)),
    )
    assert tv.chunk_pass.launches == tv.chunk_expand_pass.launches == 0


def test_rectangular_route_and_forced_colored_aux():
    """A batch's colored route: row-major entries into the longer slot
    stream, pad slots reading zeros; the colored aux carries no baked
    values."""
    ids, vals, layout = _balanced_case(2048, 8, 256, False, seed=5)
    aux = tv.build_xchg_aux(layout, ids, vals=vals, force_colored=True,
                            device="cpu")
    assert isinstance(aux.route, tv.VpermRoute) and aux.vals_dest is None
    _same_planes(aux.route, jv.build_xchg_route(layout, 2048, 8),
                 COLORED_PLANES, ("n_in", "n_out", "nc", "ch"))
    x = np.random.default_rng(6).standard_normal(2048 * 8).astype(np.float32)
    x *= vals.reshape(-1) != 0  # a product stream
    got = tv.apply_vperm(torch.as_tensor(x), aux.route).numpy()
    src = layout.src.reshape(-1)
    np.testing.assert_array_equal(got, np.where(src >= 0, x[src], 0.0))


def test_python_router_is_the_native_algorithm_and_refuses_large():
    rng = np.random.default_rng(3)
    a, b = 16, 8
    perm = rng.permutation(a * b)
    src_row = (perm // b).astype(np.int32)
    dst_row = (np.arange(a * b) // b).astype(np.int32)
    color = tc._edge_color_python(src_row, dst_row, a, b)
    np.testing.assert_array_equal(
        color, jax_edge_color_python(src_row, dst_row, a, b))
    for use_native in (True, False):
        r = tc.route_permutation(perm, a=a, b=b, use_native=use_native)
        x = rng.standard_normal(a * b).astype(np.float32)
        y = np.take_along_axis(x.reshape(a, b), r.p1, 1).T
        y = np.take_along_axis(y, r.p2, 1).T
        y = np.take_along_axis(y, r.p3, 1).reshape(-1)
        np.testing.assert_array_equal(y, x[perm])
    with pytest.raises(RuntimeError, match="too large"):
        tc.route_permutation(np.arange(tc.PYTHON_ROUTE_CAP), use_native=False)


def test_native_router_builds_into_the_ignored_build_dir():
    assert native_build.get_lib() is not None, native_build.build_error()
    path = native_build.lib_path()
    assert os.path.exists(path)
    assert os.path.dirname(path).endswith(os.path.join("photon_tpu_torch", "_build"))


def test_route_builders_reject_bad_input():
    with pytest.raises(ValueError):
        tv.route_vperm(np.array([0, 1, 1, 3]), device="cpu")
    with pytest.raises(ValueError):
        tv.pick_geometry(tv.MAX_N + 1)
    with pytest.raises(ValueError, match="injective"):
        tv.full_bijection(np.array([0, 0, -1]), 2, 4)


def test_kernel_wrappers_check_inputs():
    nc, ch = 1, 8
    x = torch.zeros(nc * ch, tv.LANES)
    lanes = torch.zeros(nc * ch, tv.LANES, dtype=torch.int8)
    rows = torch.zeros(nc * tv.LANES, ch, dtype=torch.int16)
    with pytest.raises(ValueError):
        tv.chunk_pass(x[:4], lanes, rows, lanes, nc, ch)
    with pytest.raises(TypeError):
        tv.chunk_pass(x, lanes.long(), rows, lanes, nc, ch)
    with pytest.raises(ValueError, match="power of two"):
        tv.chunk_expand_pass(torch.zeros(nc * ch, 3), lanes, rows, lanes, nc, ch)
    with pytest.raises(TypeError):
        tv.lane_pass(x.double(), lanes)
    with pytest.raises(ValueError):
        tv.lane_pass(x, lanes[:, :8])


# -- the two forms of K4 and K6 --------------------------------------------------

@pytest.mark.parametrize("nc,ch,width,form", [
    (128, 2432, 128, ("cluster", 16)),  # uniform balanced: stage B, the bake
    (128, 4096, 128, ("cluster", 16)),  # zipf colored: R1, R2
    (128, 2432, 4, ("cluster", 1)),     # uniform balanced stage A, k = 32
    (1, 2432, 128, ("cluster", 16)),    # one chunk
    (1, 5320, 128, ("cluster", 16)),    # K4's largest cluster chunk
    (1, 5328, 128, ("global", 0)),      # 8 rows above it
    (2, 8192, 128, ("global", 0)),      # the builders' cap
    (1, 100, 128, ("global", 0)),       # not a multiple of 8
    (4, 64, 128, ("cluster", 1)),       # a small chunk, one block
    (128, 2432, 1, ("cluster", 1)),     # k = 128: no selectors
    (128, 2432, 64, ("global", 0)),     # k = 2: 384 bytes a row, 912 KB
    (1, 3808, 4, ("cluster", 1)),       # k = 32: the largest one-block chunk
    (1, 3816, 4, ("global", 0)),        # 8 rows above it
    (2, 8192, 4, ("global", 0)),        # k = 32 at the builders' cap
], ids=lambda v: str(v))
def test_chunk_form_picks_the_form_and_cluster_size(nc, ch, width, form):
    assert tv.chunk_form(nc, ch, width) == form
    if form[0] == "cluster" and width == tv.LANES:
        assert tv.exchange_passes(ch, form[1]) == (4 if ch == 4096 else 1 if ch <= 2432 else 8)
    # K6 at k = 1 reads a 128-wide tile: K4's form at every shape.
    assert tv.chunk_form(nc, ch, tv.LANES) == tv.chunk_form(nc, ch, 128)


def test_chunk_form_limits_and_refusals():
    cluster = [ch for ch in range(8, tv.CH_MAX + 1, 8)
               if tv.chunk_form(1, ch, tv.LANES)[0] == "cluster"]
    assert max(cluster) == 5320 and cluster == list(range(8, 5321, 8))
    assert tv.cluster_fits(3808, 4, 1) and not tv.cluster_fits(3816, 4, 1)
    for nc, ch, width in [(0, 8, 128), (1, 0, 128), (1, tv.CH_LIMIT + 1, 128),
                          (1, 8, 3), (1, 8, 256), (1, 8, 0)]:
        with pytest.raises(ValueError):
            tv.chunk_form(nc, ch, width)


def _plane_case(nc, ch, width, seed):
    """Random in-range planes: every i1/i3 row a permutation of the lanes,
    every i2 row one of the chunk's rows."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((nc * ch, width)).astype(np.float32)
    i1 = np.argsort(rng.random((nc * ch, tv.LANES)), axis=1).astype(np.int8)
    i2 = np.argsort(rng.random((nc * tv.LANES, ch)), axis=1).astype(np.int16)
    i3 = np.argsort(rng.random((nc * ch, tv.LANES)), axis=1).astype(np.int8)
    return src, i1, i2, i3


@pytest.mark.parametrize("nc,ch", [(1, 24), (3, 16)])
def test_plain_chunk_pass_equals_jax_kernel(nc, ch):
    arrays = _plane_case(nc, ch, tv.LANES, seed=nc * ch)
    got = tv.chunk_pass(*(torch.as_tensor(a) for a in arrays), nc, ch).numpy()
    want = np.asarray(jv._chunk_pass(*(_jax(a) for a in arrays), nc, ch, True))
    np.testing.assert_array_equal(got, want)
    assert tv.chunk_pass.launches == 0


@pytest.mark.parametrize("k", [1, 128])
def test_plain_chunk_expand_equals_jax_at_the_extreme_repeats(k):
    """K6's plain version at k = 1 (the tile is the stream) and k = 128 (one
    dz value a row), one chunk, against the JAX kernel in interpret mode."""
    n = 4096 if k == 1 else 256
    ids, vals, layout = _balanced_case(n, k, 512, False, seed=k)
    ref = jv.build_xchg_aux(layout, ids, 512, vals=vals)
    aux = tv.build_xchg_aux(layout, ids, vals=vals, device="cpu")
    r = aux.route
    assert isinstance(r, tv.BalancedRoute) and r.nc == 1 and r.k_expand == k
    dz = np.random.default_rng(k).standard_normal(n).astype(np.float32)
    np.testing.assert_array_equal(
        tv.apply_balanced_dz(torch.as_tensor(dz), r).numpy(),
        np.asarray(jv.apply_balanced_dz(_jax(dz), ref.route, interpret=True)),
    )
    assert tv.chunk_expand_pass.launches == 0


def test_wrappers_launch_the_form_the_rule_picks(monkeypatch):
    """On a card tensor a wrapper launches chunk_form's choice (here caught
    before the launch); it never takes its plain version there."""
    seen = []
    monkeypatch.setattr(tv, "_cuda_tensors", lambda *ts: True)
    monkeypatch.setattr(tv, "run_chunk_form",
                        lambda wrapper, form, *args: seen.append((wrapper, form)))
    for nc, ch, width in [(1, 2432, 128), (1, 5328, 128), (1, 2432, 4)]:
        lanes = torch.zeros(nc * ch, tv.LANES, dtype=torch.int8)
        rows = torch.zeros(nc * tv.LANES, ch, dtype=torch.int16)
        src = torch.zeros(nc * ch, width)
        fn = tv.chunk_pass if width == tv.LANES else tv.chunk_expand_pass
        fn(src, lanes, rows, lanes, nc, ch)
    assert seen == [(tv.chunk_pass, ("cluster", 16)), (tv.chunk_pass, ("global", 0)),
                    (tv.chunk_expand_pass, ("cluster", 1))]


def test_run_chunk_form_refuses_cpu_tensors_and_unknown_forms():
    src, i1, i2, i3 = (torch.as_tensor(a) for a in _plane_case(1, 16, tv.LANES, 0))
    with pytest.raises(ValueError, match="CUDA"):
        tv.run_chunk_form(tv.chunk_pass, ("cluster", 1), src, i1, i2, i3, 1, 16)
    for form in [("cluster", 3), ("global", 16), ("shared", 1)]:
        with pytest.raises(ValueError, match="unknown chunk form"):
            tv.run_chunk_form(tv.chunk_pass, form, src, i1, i2, i3, 1, 16)
    assert tv.chunk_pass.form_launches == {"cluster": 0, "global": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 1, 4, 32, 128])
def test_both_forms_equal_plain_on_the_card(k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    width = tv.LANES // k if k else tv.LANES
    wrapper, plain = ((tv.chunk_expand_pass, tv.chunk_expand_pass_plain) if k
                      else (tv.chunk_pass, tv.chunk_pass_plain))
    for nc, ch in [(1, 2432), (3, 512)]:
        args = [torch.as_tensor(a).cuda() for a in _plane_case(nc, ch, width, k)]
        ref = plain(*args, nc, ch)
        for form in [tv.chunk_form(nc, ch, width), ("global", 0)]:
            got = tv.run_chunk_form(wrapper, form, *args, nc, ch)
            assert torch.equal(got, ref), form


def test_probe_chunk_forms_needs_a_card_and_lists_the_rule_forms(monkeypatch):
    from photon_tpu_torch.tools import probe_chunk_forms as tool

    assert tool.candidate_forms(2432, tv.LANES) == [("global", 0), ("cluster", 8),
                                                     ("cluster", 16)]
    assert tool.candidate_forms(2432, 4) == [("global", 0), ("cluster", 1)]
    for _, nc, ch, k in tool.CASES:
        width = tv.LANES // k if k else tv.LANES
        assert tv.chunk_form(nc, ch, width) in tool.candidate_forms(ch, width)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["probe_chunk_forms"])
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        tool.main()
