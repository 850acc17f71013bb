"""The probe kernels (PK1-PK7), the compensated scan and the three probe
tools of the port, against the JAX package's probe tools.

Each kernel's plain version (the one a CPU tensor takes) is held bit for bit
to the Pallas body it replaces, run in interpret mode on the same numpy
inputs: the kernels move data (PK3 is one f32 multiply), so any difference
is a wrong index.  The bodies of ``tools/probe_permute.py`` are closures
and are restated here verbatim with their lines; ``tools/probe_tiles.py``'s
are imported; ``tools/probe_blocklocal.py``'s run through the module's own
``_pallas`` with its ``INTERPRET`` flag set.
"""

import functools
import os
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from photon_tpu_torch.ops import _build
from photon_tpu_torch.ops import probe_kernels as pk
from photon_tpu_torch.ops.vperm import compensated_cumsum
from photon_tpu_torch.tools import probe_blocklocal, probe_permute, probe_tiles

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)
import probe_blocklocal as ref_blocklocal  # noqa: E402  (tools/, the reference)
import probe_tiles as ref_tiles  # noqa: E402

from photon_tpu.ops.vperm import _compensated_cumsum  # noqa: E402

LANES = 128
CH = ref_blocklocal.CH  # 2048
TILE = 512  # probe_permute's tile height


def _perm_rows(rng, rows, width):
    return np.argsort(rng.random((rows, width)), axis=1).astype(np.int32)


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _row_tiled(body, n_in, rows, h):
    """``body`` over ``[rows, 128]`` inputs in ``(h, 128)`` blocks, in
    interpret mode (the tools' BlockSpecs)."""
    spec = pl.BlockSpec((h, LANES), lambda i: (i, 0))
    return pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct((rows, LANES), jnp.float32),
        grid=(rows // h,), in_specs=[spec] * n_in, out_specs=spec, interpret=True,
    )


# -- tools/probe_permute.py bodies, restated verbatim -----------------------

def _permute_lane_gather_body(x_ref, idx_ref, o_ref):
    # tools/probe_permute.py:98-99 (probe_lane_gather_kernel)
    o_ref[...] = jnp.take_along_axis(x_ref[...], idx_ref[...], axis=1)


def _permute_swap_body(x_ref, m_ref, o_ref):
    # tools/probe_permute.py:151-158 (probe_benes_stage)
    x = x_ref[...]
    up = pltpu.roll(x, 32, axis=1)
    dn = pltpu.roll(x, 128 - 32, axis=1)  # roll is cyclic: -s == size-s
    m = m_ref[...]
    lane = jax.lax.broadcasted_iota(jnp.int32, x.shape, 1)
    swapped = jnp.where((lane // 32) % 2 == 0, up, dn)
    o_ref[...] = jnp.where(m > 0, swapped, x)


# -- tools/probe_blocklocal.py bodies, restated verbatim --------------------

def _block_lane_gather_body(x_ref, i_ref, o_ref):
    # tools/probe_blocklocal.py:68 (probe_tall_lane_gather) and :199
    # (probe_middle_sandwich)
    o_ref[...] = jnp.take_along_axis(x_ref[...], i_ref[...], axis=1)


def _block_transpose_body(x_ref, o_ref):
    # tools/probe_blocklocal.py:101 (probe_vmem_transpose)
    o_ref[...] = x_ref[...].T


def _block_fused_chunk_body(x_ref, i1_ref, i2_ref, i3_ref, o_ref):
    # tools/probe_blocklocal.py:146-151 (probe_fused_chunk)
    y = jnp.take_along_axis(x_ref[...], i1_ref[...], axis=1)
    y = y.T  # [128, CH] in VMEM
    y = jnp.take_along_axis(y, i2_ref[...], axis=1)
    y = y.T  # back to [CH, 128]
    o_ref[...] = jnp.take_along_axis(y, i3_ref[...], axis=1)


def _block_sublane_body(x_ref, i_ref, o_ref):
    # tools/probe_blocklocal.py:245-250 (probe_sublane_gather)
    for s in range(CH // 8):
        sl = slice(s * 8, (s + 1) * 8)
        o_ref[sl, :] = jnp.take_along_axis(
            x_ref[sl, :], i_ref[sl, :], axis=0
        )


def _block_repeat_body(x_ref, o_ref, k=32):
    # tools/probe_blocklocal.py:327-328 (probe_inkernel_repeat)
    o_ref[...] = jnp.repeat(x_ref[...], k, axis=1)


def _chunk_spec():
    return pl.BlockSpec((CH, LANES), lambda i: (i, 0))


# -- the cases ----------------------------------------------------------------

def _case_p1(rng):
    rows = 2 * TILE
    x = rng.random((rows, LANES)).astype(np.float32)
    idx = _perm_rows(rng, rows, LANES)
    want = _row_tiled(_permute_lane_gather_body, 2, rows, TILE)(x, idx)
    return pk.window_gather, (x, idx), {"window": LANES}, want


def _case_p2_masked(rng):
    rows = 2 * TILE
    x = np.arange(rows * LANES, dtype=np.float32).reshape(rows, LANES)
    m = (rng.random((rows, LANES)) < 0.5).astype(np.float32)
    want = _row_tiled(_permute_swap_body, 2, rows, TILE)(x, m)
    return pk.lane_swap, (x, m), {"h": TILE}, want


def _case_p3(kernel, h):
    def case(rng):
        rows = 1024
        x = rng.random((rows, LANES)).astype(np.float32)
        body = ref_tiles.copy_kernel if kernel == "copy" else ref_tiles.swap_kernel
        want = _row_tiled(body, 1, rows, h)(x)
        fn = pk.copy_scale if kernel == "copy" else pk.lane_swap
        return fn, (x,), {"h": h}, want
    return case


def _case_p4a(rng):
    rows = 2 * CH
    x = rng.random((rows, LANES)).astype(np.float32)
    idx = _perm_rows(rng, rows, LANES)
    want = ref_blocklocal._pallas(
        _block_lane_gather_body,
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype), grid=(rows // CH,),
        in_specs=[_chunk_spec(), _chunk_spec()], out_specs=_chunk_spec(),
    )(x, idx)
    return pk.window_gather, (x, idx), {"window": LANES}, want


def _case_p4b(rng):
    rows = 2 * CH
    x = rng.random((rows, LANES)).astype(np.float32)
    want = ref_blocklocal._pallas(
        _block_transpose_body,
        out_shape=jax.ShapeDtypeStruct((rows // CH * LANES, CH), jnp.float32),
        grid=(rows // CH,), in_specs=[_chunk_spec()],
        out_specs=pl.BlockSpec((LANES, CH), lambda i: (i, 0)),
    )(x)
    return pk.tile_transpose, (x,), {"ch": CH}, want


def _case_p4c(rng):
    rows = 2 * CH  # two chunks: the chunk offset of every index is exercised
    n_tiles = rows // CH
    x = rng.random((rows, LANES)).astype(np.float32)
    i1 = _perm_rows(rng, rows, LANES)
    i2 = _perm_rows(rng, n_tiles * LANES, CH)
    i3 = _perm_rows(rng, rows, LANES)
    want = ref_blocklocal._pallas(
        _block_fused_chunk_body,
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype), grid=(n_tiles,),
        in_specs=[_chunk_spec(), _chunk_spec(),
                  pl.BlockSpec((LANES, CH), lambda i: (i, 0)), _chunk_spec()],
        out_specs=_chunk_spec(),
    )(x, i1, i2, i3)
    return pk.fused_chunk, (x, i1, i2, i3), {"ch": CH}, want


def _case_p4d(rng):
    rows = 2 * CH
    n_tiles = rows // CH
    z = rng.random((LANES, rows)).astype(np.float32)  # the transposed view
    idx = (np.argsort(rng.random((LANES, n_tiles, CH)), axis=-1)
           .reshape(LANES, rows).astype(np.int32))
    spec = pl.BlockSpec((LANES, CH), lambda i: (0, i))
    want = ref_blocklocal._pallas(
        _block_lane_gather_body,
        out_shape=jax.ShapeDtypeStruct((LANES, rows), jnp.float32),
        grid=(n_tiles,), in_specs=[spec, spec], out_specs=spec,
    )(z, idx)
    return pk.window_gather, (z, idx), {"window": CH}, want


def _case_p4e(rng):
    rows = 2 * CH
    x = rng.random((rows, LANES)).astype(np.float32)
    idx = rng.integers(0, 8, size=(rows, LANES)).astype(np.int32)
    want = ref_blocklocal._pallas(
        _block_sublane_body,
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype), grid=(rows // CH,),
        in_specs=[_chunk_spec(), _chunk_spec()], out_specs=_chunk_spec(),
    )(x, idx)
    return pk.sublane_gather, (x, idx), {}, want


def _case_p4h(rng):
    k = 32
    rows = 2 * CH
    x = rng.random((rows, LANES // k)).astype(np.float32)
    want = ref_blocklocal._pallas(
        _block_repeat_body,
        out_shape=jax.ShapeDtypeStruct((rows, LANES), jnp.float32),
        grid=(rows // CH,),
        in_specs=[pl.BlockSpec((CH, LANES // k), lambda i: (i, 0))],
        out_specs=_chunk_spec(),
    )(x)
    return pk.lane_repeat, (x,), {"k": k}, want


CASES = {
    "P1 lane gather (PK1)": _case_p1,
    "P2 masked swap stage (PK2)": _case_p2_masked,
    "P3 copy h=32 (PK3)": _case_p3("copy", 32),
    "P3 copy h=512 (PK3)": _case_p3("copy", 512),
    "P3 swap h=32 (PK2)": _case_p3("swap", 32),
    "P3 swap h=512 (PK2)": _case_p3("swap", 512),
    "P4a tall lane gather (PK1)": _case_p4a,
    "P4b tile transpose (PK4)": _case_p4b,
    "P4c fused chunk (PK5)": _case_p4c,
    "P4d window gather (PK1)": _case_p4d,
    "P4e sublane gather (PK6)": _case_p4e,
    "P4h lane repeat (PK7)": _case_p4h,
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_equals_pallas_body(monkeypatch, case):
    monkeypatch.setattr(ref_blocklocal, "INTERPRET", True)
    rng = np.random.default_rng(sorted(CASES).index(case))
    fn, args, kwargs, want = CASES[case](rng)
    before = fn.launches
    got = fn(*(torch.as_tensor(a) for a in args), **kwargs)
    _same(got, want)
    assert fn.launches == before  # a CPU tensor takes the plain version


def test_swap_stage_reverses_the_lane_blocks():
    """The Pallas "XOR swap" (two rolls and a select) reverses the four
    32-lane blocks: output lanes 0..3 are input lanes 96..99, not 32..35."""
    x = torch.arange(2 * LANES, dtype=torch.float32).view(2, LANES)
    out = pk.lane_swap(x)
    assert out[0, :4].tolist() == [96.0, 97.0, 98.0, 99.0]
    assert torch.equal(out, x.view(2, 4, 32).flip(1).reshape(2, LANES))
    assert torch.equal(pk.lane_swap(out), x)  # an involution


def test_indices_are_masked_to_their_window():
    """Out-of-window indices wrap inside the window, in the kernels' plain
    versions as in the kernels: no read leaves its window."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.random((16, LANES)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(0, LANES, (16, LANES)).astype(np.int32))
    assert torch.equal(pk.window_gather(x, idx + LANES, LANES),
                       pk.window_gather(x, idx, LANES))
    sub = torch.as_tensor(rng.integers(0, 8, (16, LANES)).astype(np.int32))
    assert torch.equal(pk.sublane_gather(x, sub + 8), pk.sublane_gather(x, sub))


def test_fused_chunk_equals_its_five_stages():
    """PK5's composed index against the five stages done one by one in
    torch, on two chunks of a small chunk height."""
    ch, n_tiles = 64, 2
    rng = np.random.default_rng(6)
    rows = ch * n_tiles
    x = torch.as_tensor(rng.random((rows, LANES)).astype(np.float32))
    i1 = torch.as_tensor(_perm_rows(rng, rows, LANES))
    i2 = torch.as_tensor(_perm_rows(rng, n_tiles * LANES, ch))
    i3 = torch.as_tensor(_perm_rows(rng, rows, LANES))
    y = torch.take_along_dim(x.view(n_tiles, ch, LANES), i1.view(n_tiles, ch, LANES).long(), 2)
    y = torch.take_along_dim(y.transpose(1, 2), i2.view(n_tiles, LANES, ch).long(), 2)
    y = torch.take_along_dim(y.transpose(1, 2), i3.view(n_tiles, ch, LANES).long(), 2)
    assert torch.equal(pk.fused_chunk(x, i1, i2, i3, ch), y.reshape(rows, LANES))


def _chunk_planes(rng, ch, n_tiles):
    rows = ch * n_tiles
    x = rng.random((rows, LANES)).astype(np.float32)
    i1 = _perm_rows(rng, rows, LANES)
    i2 = _perm_rows(rng, n_tiles * LANES, ch)
    i3 = _perm_rows(rng, rows, LANES)
    return x, i1, i2, i3


@pytest.mark.parametrize("ch,n_tiles,out_of_range", [
    (8, 1, False), (8, 4, True), (64, 3, False), (64, 2, True),
    (256, 1, False), (256, 4, True),
], ids=lambda v: str(v))
def test_fused_chunk_plain_equals_pallas_body(monkeypatch, ch, n_tiles, out_of_range):
    """PK5's plain version against the Pallas body of
    tools/probe_blocklocal.py:146-151 in interpret mode, at the chunk heights
    of the block form.  Out of range, the port takes ``i1 + 128``, ``i2 +
    ch`` and ``i3 - 128`` and masks them back to the planes the Pallas body
    takes."""
    monkeypatch.setattr(ref_blocklocal, "INTERPRET", True)
    x, i1, i2, i3 = _chunk_planes(np.random.default_rng(ch + n_tiles), ch, n_tiles)
    rows_spec = pl.BlockSpec((ch, LANES), lambda i: (i, 0))
    want = ref_blocklocal._pallas(
        _block_fused_chunk_body,
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype), grid=(n_tiles,),
        in_specs=[rows_spec, rows_spec, pl.BlockSpec((LANES, ch), lambda i: (i, 0)),
                  rows_spec],
        out_specs=rows_spec,
    )(x, i1, i2, i3)
    if out_of_range:
        i1, i2, i3 = i1 + LANES, i2 + ch, i3 - LANES
    before = pk.fused_chunk.launches
    got = pk.fused_chunk(*(torch.as_tensor(a) for a in (x, i1, i2, i3)), ch)
    _same(got, want)
    assert pk.fused_chunk.launches == before


# The form PK5's rule picks at the tool's chunk heights: one block a chunk
# (several chunks below 64 rows) up to 256 rows; a cluster of ch / 128
# blocks in two passes, two blocks an SM, up to 2048; 16 blocks of one
# block an SM at 4096; one thread an element from 8192.
FUSED_FORMS = {
    1: ("block", 64, 1), 8: ("block", 8, 1), 32: ("block", 2, 1), 64: ("block", 1, 1),
    128: ("block", 1, 1), 256: ("block", 1, 1), 512: ("cluster", 4, 2),
    1024: ("cluster", 8, 2), 2048: ("cluster", 16, 2), 4096: ("cluster", 16, 2),
    8192: ("global", 0, 0), 16384: ("global", 0, 0),
}


def _form_smem(nc: int, ch: int) -> int:
    """Shared memory a block of the form PK5's rule picks uses (0: global)."""
    form, arg, passes = pk.fused_chunk_form(nc, ch)
    if form == "block":
        return pk.fused_block_smem(ch, arg)
    return pk.fused_cluster_smem(ch, arg, passes) if form == "cluster" else 0


@pytest.mark.parametrize("ch", list(FUSED_FORMS))
def test_fused_chunk_form_picks_the_form(ch):
    for nc in (1, 128):
        assert pk.fused_chunk_form(nc, ch) == FUSED_FORMS[ch]
        assert _form_smem(nc, ch) <= pk.SMEM_BLOCK == 232_448
    form, arg, passes = FUSED_FORMS[ch]
    if form == "cluster":
        # Two blocks an SM wherever a cluster of at most 16 blocks allows it.
        two = pk.fused_cluster_smem(ch, arg, passes) <= pk.SMEM_HALF_SM
        assert two == (ch <= 2048)
        assert ch % (arg * pk.TILE_ROWS) == 0 and (ch // arg) % (4 * passes) == 0
    elif form == "block":
        assert arg * ch >= pk.GROUP_ROWS


def test_fused_chunk_form_limits_and_refusals():
    """Every power-of-two chunk height up to 2^24 takes a form whose block
    fits in 232,448 bytes; the block form ends at 256 rows, the cluster form
    at 4096; a shape no form takes raises."""
    forms = {}
    for shift in range(25):
        ch = 1 << shift
        form = pk.fused_chunk_form(3, ch)
        forms.setdefault(form[0], []).append(ch)
        assert _form_smem(3, ch) <= pk.SMEM_BLOCK
    assert max(forms["block"]) == 256 and min(forms["cluster"]) == 512
    assert max(forms["cluster"]) == 4096 and min(forms["global"]) == 8192
    assert pk.fused_block_smem(256, 1) == 197_120
    assert pk.fused_cluster_smem(2048, 16, 2) == 98_304
    assert pk.fused_cluster_smem(4096, 16, 1) > pk.SMEM_BLOCK
    for nc, ch in [(0, 8), (1, 0), (1, 3), (1, 100), (1, -8), (1, 1 << 25)]:
        with pytest.raises(ValueError, match="no PK5 form"):
            pk.fused_chunk_form(nc, ch)


def test_fused_chunk_launches_the_form_the_rule_picks(monkeypatch):
    """On a card tensor PK5 launches the rule's form (caught at the launch
    here, no card needed), counts it, and never takes its plain version."""
    seen = []
    monkeypatch.setattr(pk, "_on_card", lambda *ts: True)
    monkeypatch.setattr(pk, "_launch", lambda name, argtypes, x, *args: seen.append(
        (name, args[5:])))
    monkeypatch.setattr(pk, "fused_chunk_plain", None)  # a call would raise
    monkeypatch.setattr(pk.fused_chunk, "launches", 0)
    monkeypatch.setattr(pk.fused_chunk, "form_launches",
                        {"block": 0, "cluster": 0, "global": 0})
    for ch, nc in [(8, 4), (2048, 1), (8192, 1)]:
        rows = ch * nc
        lanes = torch.zeros(rows, LANES, dtype=torch.int32)
        pk.fused_chunk(torch.zeros(rows, LANES), lanes,
                       torch.zeros(nc * LANES, ch, dtype=torch.int32), lanes, ch)
    assert seen == [("fused_chunk", (4, 8, 1, 8, 1)), ("fused_chunk", (1, 2048, 2, 16, 2)),
                    ("fused_chunk", (1, 8192, 0, 0, 0))]
    assert pk.fused_chunk.form_launches == {"block": 1, "cluster": 1, "global": 1}
    assert pk.fused_chunk.launches == 3


@pytest.mark.parametrize("name", ["copy_scale", "fused_chunk", "lane_swap x",
                                  "lane_swap mask"])
def test_card_wrappers_refuse_misaligned_tensors(monkeypatch, name):
    """PK2, PK3 and PK5 move 16 bytes a lane: a tensor that does not start
    on a 16-byte boundary raises before any launch (no plain fallback)."""
    monkeypatch.setattr(pk, "_on_card", lambda *ts: True)
    monkeypatch.setattr(pk, "_launch", lambda *a: pytest.fail("launched"))
    flat = torch.zeros(64 * LANES + 1)
    x = flat[1:].view(64, LANES)
    assert x.data_ptr() % 16
    aligned = torch.zeros(64, LANES)
    with pytest.raises(ValueError, match="16-byte aligned"):
        if name == "copy_scale":
            pk.copy_scale(x, h=8)
        elif name == "lane_swap x":
            pk.lane_swap(x, aligned, h=8)
        elif name == "lane_swap mask":
            pk.lane_swap(aligned, x, h=8)
        else:
            lanes = torch.zeros(64, LANES, dtype=torch.int32)
            pk.fused_chunk(x, lanes, torch.zeros(LANES, 64, dtype=torch.int32), lanes, 64)


def test_lane_repeat_takes_an_input_only_float_aligned(monkeypatch):
    """PK7 reads x by 4-byte loads: a view 4 bytes past a 16-byte boundary
    launches (caught at the launch here, no card needed); only its own
    output must be 16-byte aligned."""
    seen = []
    monkeypatch.setattr(pk, "_on_card", lambda *ts: True)
    monkeypatch.setattr(pk, "_launch", lambda name, argtypes, x, *args: seen.append(
        (name, args)))
    monkeypatch.setattr(pk, "lane_repeat_plain", None)  # a call would raise
    monkeypatch.setattr(pk.lane_repeat, "launches", 0)
    flat = torch.zeros(64 * 4 + 1)
    x = flat[1:].view(64, 4)
    assert x.data_ptr() % 16 == 4
    out = pk.lane_repeat(x, 32)
    assert out.shape == (64, LANES) and out.data_ptr() % 16 == 0
    assert seen == [("lane_repeat", (x.data_ptr(), out.data_ptr(), 64, 32))]
    assert pk.lane_repeat.launches == 1


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16, 32, 64, 128])
def test_lane_repeat_plain_equals_pallas_body_at_every_k(monkeypatch, k):
    """PK7's plain version against tools/probe_blocklocal.py:327-328 (the
    body, with k passed in) in interpret mode, at every k the wrapper
    takes."""
    monkeypatch.setattr(ref_blocklocal, "INTERPRET", True)
    rows, h = 96, 32
    x = np.random.default_rng(k).random((rows, LANES // k)).astype(np.float32)
    want = ref_blocklocal._pallas(
        functools.partial(_block_repeat_body, k=k),
        out_shape=jax.ShapeDtypeStruct((rows, LANES), jnp.float32), grid=(rows // h,),
        in_specs=[pl.BlockSpec((h, LANES // k), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((h, LANES), lambda i: (i, 0)),
    )(x)
    _same(pk.lane_repeat(torch.as_tensor(x), k), want)


@pytest.mark.parametrize("rows,h_ref,h", [(1023, 31, 512), (999, 27, 8192), (7, 7, 3)],
                         ids=lambda v: str(v))
def test_copy_scale_plain_equals_pallas_body_at_odd_rows(rows, h_ref, h):
    """PK3's plain version against tools/probe_tiles.py's copy_kernel in
    interpret mode at odd row counts; the port's tile height need not divide
    the rows (the kernel's last tile is short)."""
    x = np.random.default_rng(rows).random((rows, LANES)).astype(np.float32)
    want = _row_tiled(ref_tiles.copy_kernel, 1, rows, h_ref)(x)
    _same(pk.copy_scale(torch.as_tensor(x), h=h), want)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("rows,h_ref,h", [(1023, 31, 512), (999, 27, 8192), (7, 7, 3)],
                         ids=lambda v: str(v))
def test_lane_swap_plain_equals_pallas_body_at_odd_rows(rows, h_ref, h, masked):
    """PK2's plain version against the swap bodies of tools/probe_tiles.py
    (swap_kernel, unmasked) and tools/probe_permute.py:151-158 (masked) in
    interpret mode at odd row counts; the port's tile height need not divide
    the rows (the kernel's last unit is short)."""
    rng = np.random.default_rng(rows + masked)
    x = rng.random((rows, LANES)).astype(np.float32)
    if masked:
        m = (rng.random((rows, LANES)) < 0.5).astype(np.float32)
        want = _row_tiled(_permute_swap_body, 2, rows, h_ref)(x, m)
        got = pk.lane_swap(torch.as_tensor(x), torch.as_tensor(m), h=h)
    else:
        want = _row_tiled(ref_tiles.swap_kernel, 1, rows, h_ref)(x)
        got = pk.lane_swap(torch.as_tensor(x), h=h)
    _same(got, want)


def test_lane_swap_validates_h():
    x = torch.zeros(8, LANES)
    for h in (0, -1, 2 ** 31):
        with pytest.raises(ValueError, match="h must be"):
            pk.lane_swap(x, h=h)
        with pytest.raises(ValueError, match="h must be"):
            pk.lane_swap(x, x, h=h)
    assert torch.equal(pk.lane_swap(x, h=2 ** 31 - 1), x)


def test_copy_scale_validates_h():
    x = torch.zeros(8, LANES)
    for h in (0, -1, 2 ** 31):
        with pytest.raises(ValueError, match="h must be"):
            pk.copy_scale(x, h=h)
    assert torch.equal(pk.copy_scale(x, h=2 ** 31 - 1), x)


def test_compensated_cumsum_matches_reference_scan():
    """Both scans combine the same two-sum pairs in different orders, so
    neither equals the other bit for bit; each one's ``hi + lo`` (in float64)
    is held to the exact prefix sum.  The pair carries about 48 bits, so the
    bound is 2^-44 (16 units of 2^-48) of the running sum of magnitudes; a
    plain float32 cumsum misses it by orders of magnitude."""
    x = np.random.default_rng(7).standard_normal(1 << 16).astype(np.float32)
    exact = np.cumsum(x.astype(np.float64))
    bound = 2.0 ** -44 * np.cumsum(np.abs(x.astype(np.float64)))
    hi, lo = compensated_cumsum(torch.as_tensor(x))
    ours = hi.double().numpy() + lo.double().numpy()
    rhi, rlo = _compensated_cumsum(jnp.asarray(x))
    theirs = np.asarray(rhi, np.float64) + np.asarray(rlo, np.float64)
    assert np.all(np.abs(ours - exact) <= bound)
    assert np.all(np.abs(theirs - exact) <= bound)
    plain = np.cumsum(x).astype(np.float64)  # float32 running sum
    assert np.max(np.abs(plain - exact) / bound) > 100
    assert hi.dtype == lo.dtype == torch.float32


def _reference_rows(path: str) -> list:
    """The row letters a reference tool prints (``print(f"a. ...``)."""
    with open(path) as f:
        return sorted(set(re.findall(r'print\(f?"([a-i])\. ', f.read())))


@pytest.mark.parametrize("tool", ["probe_permute", "probe_blocklocal"])
def test_tool_prints_every_reference_row(monkeypatch, capsys, tool):
    module = {"probe_permute": probe_permute, "probe_blocklocal": probe_blocklocal}[tool]
    letters = _reference_rows(os.path.join(TOOLS, f"{tool}.py"))
    assert len(letters) == (9 if tool == "probe_permute" else 8)
    monkeypatch.setattr(sys, "argv", [tool, "--device", "cpu", "--entries", "262144"])
    module.main()
    out = capsys.readouterr().out
    assert "FAILED" not in out and "UNSUPPORTED" not in out, out
    lines = out.splitlines()
    for letter in letters:
        assert any(line.startswith(f"{letter}. ") for line in lines), (letter, out)


def test_tiles_tool_prints_every_sweep_row(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["probe_tiles", "--device", "cpu",
                                      "--entries", "262144"])
    probe_tiles.main()
    out = capsys.readouterr().out
    assert "FAILED" not in out and "elementwise baseline" in out
    rows = 262144 // LANES
    heights = [h for h in probe_tiles.HEIGHTS if rows % h == 0]
    assert heights == [8, 32, 128, 512, 2048]  # the reference's sweep at 2^18
    for name in ("copy (PK3)", "swap (PK2)"):
        for h in heights:
            assert f"{name} h={h:<5}" in out, (name, h)


def test_probe_functions_raise_outside_main():
    """A probe called directly lets its failure through (main() reports)."""
    with pytest.raises(ValueError, match="below one group"):
        probe_permute.probe_onehot_segsum(1 << 10, torch.device("cpu"))


WRAPPERS = {
    "window_gather": lambda d: (pk.window_gather, (torch.zeros(4, LANES, device=d),
                                torch.zeros(4, LANES, dtype=torch.int32, device=d), LANES)),
    "lane_swap": lambda d: (pk.lane_swap, (torch.zeros(4, LANES, device=d),)),
    "copy_scale": lambda d: (pk.copy_scale, (torch.zeros(4, LANES, device=d),)),
    "tile_transpose": lambda d: (pk.tile_transpose, (torch.zeros(64, LANES, device=d), 32)),
    "fused_chunk": lambda d: (pk.fused_chunk, (
        torch.zeros(64, LANES, device=d), torch.zeros(64, LANES, dtype=torch.int32, device=d),
        torch.zeros(LANES, 64, dtype=torch.int32, device=d),
        torch.zeros(64, LANES, dtype=torch.int32, device=d), 64)),
    "sublane_gather": lambda d: (pk.sublane_gather, (
        torch.zeros(8, LANES, device=d), torch.zeros(8, LANES, dtype=torch.int32, device=d))),
    "lane_repeat": lambda d: (pk.lane_repeat, (torch.zeros(8, 4, device=d), 32)),
}


def _unbuilt(monkeypatch, tmp_path):
    """No built library and no nvcc: a launch has to build, and cannot."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_card_tensor_with_kernel_unbuilt_raises(monkeypatch, tmp_path, name):
    """A wrapper handed tensors it takes for the card's launches or raises:
    it never falls back to the plain version (here the card is simulated,
    so the test runs without one)."""
    _unbuilt(monkeypatch, tmp_path)
    monkeypatch.setattr(pk, "_on_card", lambda *ts: True)
    fn, args = WRAPPERS[name]("cpu")
    monkeypatch.setattr(fn, "launches", fn.launches)
    with pytest.raises(RuntimeError, match="nvcc"):
        fn(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(WRAPPERS))
def test_cuda_tensor_with_kernel_unbuilt_raises(monkeypatch, tmp_path, name):
    """The same on real CUDA tensors (on a machine with a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    _unbuilt(monkeypatch, tmp_path)
    fn, args = WRAPPERS[name]("cuda")
    monkeypatch.setattr(fn, "launches", fn.launches)
    with pytest.raises(RuntimeError, match="nvcc"):
        fn(*args)
