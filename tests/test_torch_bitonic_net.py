"""Port parity of the bitonic-schedule experiments (tools/exp_bitonic*.py).

Each JAX experiment kernel runs through ``pl.pallas_call(...,
interpret=True)`` at a small size (n = 1024 or 2048 elements, P = 3 or 5
planes), its module globals (S, P, ITERS, SUBS, N) set with monkeypatch,
and the port's row (henjou_torch/tools/exp_bitonic*.py) runs on the same
input on the CPU, where the kernel wrappers take their plain versions.
The two must be equal to the bit on every plane. Keys are drawn in
[0, 32) so that ties occur: the network is not stable, and the port must
keep the TPU kernels' tie order. The roll rows are held to a numpy
formula and to the JAX kernels started from the input (their output
buffer aliased to it; unaliased, the JAX kernels read it uninitialised).
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from henjou_torch.accel import bitonic as tbit
from henjou_torch.accel import bitonic_net as bn
from henjou_torch.tools import exp_bitonic as t1
from henjou_torch.tools import exp_bitonic2 as t2
from henjou_torch.tools import exp_bitonic3 as t3
from henjou_torch.tools import exp_bitonic4 as t4
from henjou_tpu.accel.bitonic import _substages

# one intra-op thread: the test lane runs several pytest workers at once
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = 128
S = 16  # 2048 elements
S_UNROLLED = 8  # 1024 elements (55 substages, odd) for the fully unrolled kernels
ITERS = 6  # even: the last iteration writes the output buffer


@functools.cache
def _jax_tool(name):
    """tools/<name>.py, imported by path (tools/ is not a package)."""
    path = os.path.join(ROOT, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(*_):
    pass


def _input(p, n, seed=0):
    """[p, n] int32: keys in [0, 32) (ties), planes over the int32 range."""
    rng = np.random.default_rng(seed)
    st = rng.integers(-2**31, 2**31 - 1, (p, n)).astype(np.int32)
    st[0] = rng.integers(0, 32, n)
    return st


def _pallas(kern, inp, *, smem=(), scratch=True, alias=False):
    """Run `kern` in interpret mode on the [p, n] array `inp` as [p, s,
    128] VMEM planes, after the SMEM arguments `smem`; returns [p, n]."""
    p, n = inp.shape
    shape = (p, n // LANES, LANES)
    kw = {"input_output_aliases": {len(smem): 0}} if alias else {}
    out = pl.pallas_call(
        kern,
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] * len(smem)
        + [pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(shape, jnp.int32),
        scratch_shapes=[pltpu.VMEM(shape, jnp.int32)] if scratch else [],
        interpret=True,
        **kw,
    )(*[jnp.asarray(a) for a in smem], jnp.asarray(inp.reshape(shape)))
    return np.asarray(out).reshape(p, n)


def _equal(port_out, jax_out):
    got = port_out.cpu().numpy()
    assert got.shape == jax_out.shape
    for p in range(got.shape[0]):
        assert np.array_equal(got[p], jax_out[p]), f"plane {p} differs"


def _np_substage(x, k, j):
    """numpy reference of one substage: partner i ^ j, strict compares."""
    i = np.arange(x.shape[1])
    partner = x[:, i ^ j]
    take_min = ((i & j) == 0) == ((i & k) == 0)
    swap = np.where(take_min, x[0] > partner[0], x[0] < partner[0])
    return np.where(swap, partner, x)


def _np_roll(x, iters):
    """numpy reference of `iters` roll passes, wrapping int32."""
    y = x.reshape(x.shape[0], -1, LANES).astype(np.int64)
    for _ in range(iters):
        y = (np.roll(y, 16, axis=2) + np.roll(y, 112, axis=2)).astype(np.int32).astype(np.int64)
    return y.astype(np.int32).reshape(x.shape)


# ---------------- exp_bitonic.py: kern_switch, kern_unroll ----------------


@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("variant", ["switch", "unroll"])
def test_exp1_kernels_match_port(variant, p):
    e1 = _jax_tool("exp_bitonic")
    n = 1024  # 55 substages: odd, so the JAX kernels copy buf to out
    s = n // LANES
    subs = _substages(n)
    inp = _input(p, n, seed=p)
    if variant == "switch":
        jk = np.asarray([[j.bit_length() - 1 for _, j in subs], [k for k, _ in subs]], np.int32)
        kern = functools.partial(e1.kern_switch, n_sub=len(subs), s=s, n_j=n.bit_length() - 1)
        ref = _pallas(kern, inp, smem=(jk,))
    else:
        ref = _pallas(functools.partial(e1.kern_unroll, subs=subs, s=s), inp)
    row = t1.run_variant("row", n, p - 1, variant, "cpu", state=inp, reps=0, log=_quiet)
    _equal(row["out"], ref)
    assert row["ok"]


# ---------------- exp_bitonic2.py: kern_a .. kern_g ----------------


@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("row", ["a", "b", "c", "d"])
def test_exp2_substage_kernels_match_port(monkeypatch, row, p):
    e2 = _jax_tool("exp_bitonic2")
    for name, v in (("S", S), ("P", p), ("ITERS", ITERS)):
        monkeypatch.setattr(e2, name, v)
    inp = _input(p, S * LANES, seed=10 + p)
    ref = _pallas(getattr(e2, f"kern_{row}"), inp)
    out = t2.run("row", row, "cpu", s=S, p=p, iters=ITERS, state=inp, reps=0, log=_quiet)["out"]
    _equal(out, ref)
    # one substage's result, as the loop of idempotent substages leaves
    k, j = (1024, 512) if row == "b" else (32, 16)
    assert np.array_equal(out.numpy(), _np_substage(inp, k, j))


@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("row", ["e", "f"])
def test_exp2_roll_kernels_match_port(monkeypatch, row, p):
    """Rows E and F against numpy's roll and against the JAX kernels run
    from the input (output aliased to the input)."""
    e2 = _jax_tool("exp_bitonic2")
    for name, v in (("S", S), ("P", p), ("ITERS", ITERS)):
        monkeypatch.setattr(e2, name, v)
    inp = _input(p, S * LANES, seed=20)
    out = t2.run("row", row, "cpu", s=S, p=p, iters=ITERS, state=inp, reps=0, log=_quiet)["out"]
    assert np.array_equal(out.numpy(), _np_roll(inp, ITERS))
    _equal(out, _pallas(getattr(e2, f"kern_{row}"), inp, alias=True))


def test_pltpu_roll_direction_is_torch_roll():
    """roll_pass's plain version assumes pltpu.roll shifts as np.roll and
    torch.roll do (toward higher indices); check one asymmetric shift."""
    x = np.arange(8 * LANES, dtype=np.int32).reshape(8, LANES)

    def kern(x_ref, o_ref):
        o_ref[:] = pltpu.roll(x_ref[:], 16, axis=1)

    got = pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32),
                         interpret=True)(jnp.asarray(x))
    assert np.array_equal(np.asarray(got), torch.roll(torch.from_numpy(x), 16, dims=1).numpy())


@pytest.mark.parametrize("p", [3, 5])
def test_exp2_full_schedule_kernel_matches_port(monkeypatch, p):
    e2 = _jax_tool("exp_bitonic2")
    monkeypatch.setattr(e2, "S", S_UNROLLED)
    monkeypatch.setattr(e2, "P", p)
    inp = _input(p, S_UNROLLED * LANES, seed=30 + p)
    ref = _pallas(functools.partial(e2.kern_g, subs=_substages(S_UNROLLED * LANES)), inp)
    row = t2.run_g("cpu", s=S_UNROLLED, p=p, state=inp, reps=0, log=_quiet)
    _equal(row["out"], ref)
    assert row["ok"]


# ---------------- exp_bitonic3.py: kern_inplace, kern_inplace_aliased ----------------


@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("kind", ["copy", "aliased"])
def test_exp3_inplace_kernels_match_port(monkeypatch, kind, p):
    e3 = _jax_tool("exp_bitonic3")
    n = S_UNROLLED * LANES
    for name, v in (("S", S_UNROLLED), ("P", p), ("N", n), ("SUBS", _substages(n))):
        monkeypatch.setattr(e3, name, v)
    inp = _input(p, n, seed=40)
    kern = e3.kern_inplace if kind == "copy" else e3.kern_inplace_aliased
    ref = _pallas(kern, inp, scratch=False, alias=kind == "aliased")
    row = t3.run("row", kind, "cpu", s=S_UNROLLED, p=p, state=inp, reps=0, log=_quiet)
    _equal(row["out"], ref)
    assert row["ok"]


# ---------------- exp_bitonic4.py: make_loop variants ----------------


@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("row", ["x1", "x2", "x5", "x3", "x4"])
def test_exp4_loop_kernels_match_port(monkeypatch, row, p):
    """The make_loop kernels over x1, x2, x5 and the guard chains, with
    the JAX script's tables: the schedule's (j, k) for x1, x2 and x5, a
    zero j row for the guards. ITERS is the whole schedule of n = 2048,
    so X5 is a full sort; X2 passes k == j = 16 on four iterations."""
    e4 = _jax_tool("exp_bitonic4")
    n = S * LANES
    subs = _substages(n)
    for name, v in (("S", S), ("P", p), ("ITERS", len(subs))):
        monkeypatch.setattr(e4, name, v)
    jk = np.asarray([[j for _, j in subs], [k for k, _ in subs]], np.int32)
    fn = {"x1": e4.x1, "x2": e4.x2, "x5": e4.x5,
          "x3": e4.guard_chain(4), "x4": e4.guard_chain(16)}[row]
    if row in ("x3", "x4"):
        jk = np.stack([jk[0] * 0, jk[1]])
    inp = _input(p, n, seed=50)
    ref = _pallas(e4.make_loop(fn), inp, smem=(jk,))
    out = t4.run("row", row, "cpu", s=S, p=p, iters=len(subs), state=inp, reps=0, log=_quiet)["out"]
    _equal(out, ref)
    if row == "x5":
        assert np.array_equal(out[0].numpy(), np.sort(inp[0]))


# ---------------- the plain network and the wrappers ----------------


def test_plain_network_matches_numpy_and_keeps_pairs():
    """A full sort through `net_walk` (plain on the CPU) equals the numpy
    network substage by substage, and every (key, payload) column is
    kept: the output columns are a permutation of the input columns."""
    n, p = 1024, 4
    inp = _input(p, n, seed=60)
    inp[1] = np.arange(n)  # a lane id
    x = inp
    for k, j in bn.substages(n):
        x = _np_substage(x, k, j)
    state = torch.from_numpy(inp)
    out = bn.net_walk(state, bn.make_schedule(bn.substages(n), n, "cpu"))
    assert np.array_equal(out.numpy(), x)
    assert np.array_equal(out[0].numpy(), np.sort(inp[0]))
    assert np.array_equal(inp[:, out[1].numpy()], out.numpy())


def test_host_walk_and_local_runs_equal_the_walk():
    """The host-walked sort (net_local runs plus net_substage for j >=
    TILE) and the per-plane walk of row G give the walk's result at
    n = 4096, where the schedule has substages with j >= TILE."""
    n = 4096
    state = torch.from_numpy(_input(3, n, seed=70))
    subs = bn.substages(n)
    walked = bn.net_walk(state, bn.make_schedule(subs, n, "cpu"))
    ops = bn.ops()
    assert torch.equal(t1.host_walk(state, subs, ops), walked)
    assert torch.equal(t2.sort_per_plane(state, subs, ops), walked)
    inplace = state.clone()
    assert bn.net_walk(inplace, bn.make_schedule(subs, n, "cpu"), inplace=True) is inplace
    assert torch.equal(inplace, walked)


def test_wrappers_reject_what_the_kernels_do_not_take():
    state = torch.from_numpy(_input(3, 1024))
    with pytest.raises(ValueError):
        bn.net_substage(state, 32, 16, dst=state, per_plane=True)  # per plane in place
    with pytest.raises(ValueError):
        bn.net_substage(state, 64, 16, mode="static")  # not a compiled pair
    with pytest.raises(ValueError):
        bn.net_substage(state, 32, 16, guards=3)
    with pytest.raises(ValueError):
        bn.net_local(state, [(2048, 1024)])  # j >= TILE
    with pytest.raises(ValueError):
        bn.roll_pass(state, dst=state)
    with pytest.raises(ValueError):
        bn.net_walk(state, bn.make_schedule(bn.substages(2048), 2048, "cpu"))
    with pytest.raises(ValueError):
        bn.net_substage(torch.zeros((3, 1000), dtype=torch.int32), 2, 1)
    with pytest.raises(ValueError):
        bn.make_schedule([(4, 3)], 1024, "cpu")


def test_to_state_bitcasts_payloads():
    key = torch.arange(1024, dtype=torch.int32)
    f = torch.linspace(-1, 1, 1024)
    st = bn.to_state(key, f)
    assert st.dtype == torch.int32 and torch.equal(st[1].view(torch.float32), f)


# ---------------- the keyed network engine, modelled on the CPU ----------------


def _word_model(state, subs, tile, *, whole, group=tbit.NETWORK_GROUP):
    """csrc/keyed_network.cuh in plain torch, group by group as the kernel
    runs the plan of `bitonic.plan_passes` and `plan_groups`: int64 words
    key << 32 | source (ordered as the kernel's unsigned words with the
    key's sign bit flipped); each group's thread holds the words of the
    elements spread(g) | offset(a), within each tile for a local pass and
    over the whole array for a global one; then the gather through the
    sources. `whole` compares whole words (bitonic_sort), else the key
    halves (net_walk)."""
    n = state.shape[1]
    w = (state[0].long() << 32) | torch.arange(n)
    tl = min(tile, n)

    def above(a, b):
        return a > b if whole else (a >> 32) > (b >> 32)

    def settle(i, j, k, mine, other):
        take_min = ((i & j) == 0) == ((i & k) == 0)
        return torch.where(torch.where(take_min, above(mine, other), above(other, mine)),
                           other, mine)

    def run_group(first, count, span, bases):
        """One group over blocks of `span` elements at `bases` ([B, 1])."""
        run = subs[first:first + count]
        js = [j for _, j in run]
        assert count <= group and len(set(js)) == count and max(js) < span
        b = torch.arange(span >> count)
        for pos in sorted(j.bit_length() - 1 for j in js):  # a zero bit at each
            b = ((b >> pos) << (pos + 1)) | (b & ((1 << pos) - 1))
        at = [bases + (b | sum(js[q] for q in range(count) if (a >> q) & 1))
              for a in range(1 << count)]
        assert torch.equal(torch.cat([x.reshape(-1) for x in at]).sort().values, torch.arange(n))
        ws = [w[x] for x in at]
        for q, (k, j) in enumerate(run):
            for a in range(1 << count):
                if not (a >> q) & 1:
                    h = a | (1 << q)
                    ws[a], ws[h] = (settle(at[a], j, k, ws[a], ws[h]),
                                    settle(at[h], j, k, ws[h], ws[a]))
        for x, v in zip(at, ws):
            w[x] = v

    for kind, first, count in tbit.plan_passes(subs, tile, group):
        if kind == "local":
            for f, c in tbit.plan_groups(subs, first, count, group):
                run_group(f, c, tl, torch.arange(0, n, tl)[:, None])
        else:
            assert min(j for _, j in subs[first:first + count]) >= tl
            run_group(first, count, n, torch.zeros(1, 1, dtype=torch.long))
    src = w & 0xFFFFFFFF
    return torch.cat([(w >> 32).to(torch.int32)[None], state[1:, src]])


def _keys(kind, n, rng):
    """[n] int32 keys: "ties" in [0, 32), "negative" over the whole int32
    range with its two extremes and repeats."""
    if kind == "ties":
        return rng.integers(0, 32, n).astype(np.int32)
    key = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    key[:8] = [-2**31, 2**31 - 1, -1, 0, -2**31, 2**31 - 1, -1, 0]
    key[8:n // 4] = key[rng.integers(0, 8, n // 4 - 8)]
    return key


def test_word_order_is_the_signed_key_order():
    """The kernel's words ((key ^ 0x80000000) << 32 | src, unsigned) order
    as the model's (key << 32 | src, signed), negative keys included."""
    rng = np.random.default_rng(80)
    key = _keys("negative", 4096, rng)
    src = np.arange(4096, dtype=np.uint64)
    kernel_words = ((key.view(np.uint32) ^ np.uint32(0x80000000)).astype(np.uint64) << 32) | src
    model_words = (key.astype(np.int64) << 32) | src.astype(np.int64)
    assert np.array_equal(np.argsort(kernel_words, kind="stable"),
                          np.argsort(model_words, kind="stable"))


_MIXED = [(8192, 4096), (4096, 4096), (2048, 2048), (16, 16), (8192, 1024), (2, 1),
          (4096, 2048), (4096, 2048), (64, 4096), (8192, 4096), (2048, 2048), (32, 16)]


@pytest.mark.parametrize("tile,group", [(2048, 3), (4096, 3), (2048, 2)])
@pytest.mark.parametrize("sched,keys", [("full", "ties"), ("full", "negative"),
                                        ("odd55", "ties"), ("mixed k == j", "ties")])
def test_word_model_equals_net_walk_plain(sched, keys, tile, group):
    """The engine's arithmetic with the key-half compare equals the plain
    network on every plane: ties never move, a k == j substage duplicates
    as the plain version does, at n = 8192 (global passes at both tiles)."""
    n = 8192
    rng = np.random.default_rng(81)
    st = rng.integers(-2**31, 2**31 - 1, (3, n)).astype(np.int32)
    st[0] = _keys(keys, n, rng)
    subs = {"full": bn.substages(n), "odd55": bn.substages(n)[:55], "mixed k == j": _MIXED}[sched]
    state = torch.from_numpy(st)
    want = bn.net_walk_plain(state, bn.make_schedule(subs, n, "cpu"))
    assert torch.equal(_word_model(state, subs, tile, whole=False, group=group), want)


@pytest.mark.parametrize("keys", ["ties", "negative"])
@pytest.mark.parametrize("n,tile", [(1024, 2048), (8192, 2048), (8192, 4096)])
def test_word_model_whole_equals_bitonic_sort_plain(n, tile, keys):
    """The engine's arithmetic with the whole-word compare is the stable
    sort of `bitonic_sort_plain`, payload included."""
    rng = np.random.default_rng(82)
    st = rng.integers(-2**31, 2**31 - 1, (4, n)).astype(np.int32)
    st[0] = _keys(keys, n, rng)
    state = torch.from_numpy(st)
    want = tbit.bitonic_sort_plain(state[0], *state[1:])
    got = _word_model(state, tbit.substages(n), tile, whole=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------- the four tools' entry points ----------------


@pytest.mark.parametrize("tool,argv,sizes,names", [
    (t1, [], dict(n=1024, reps=1), [v[0] for v in t1.VARIANTS]),
    (t2, ["g"], dict(s=S, p=3, iters=ITERS, reps=1), [r[0] for r in t2.ROWS] + [t2.G_NAME]),
    (t3, ["all"], dict(s=S, p=3, reps=1), [r[1] for r in t3.ROWS]),
    (t4, [], dict(s=S, p=3, iters=len(_substages(S * LANES)), reps=1), [r[0] for r in t4.ROWS]),
], ids=["exp_bitonic", "exp_bitonic2", "exp_bitonic3", "exp_bitonic4"])
def test_tool_main_runs_every_row_on_the_cpu(capsys, tool, argv, sizes, names):
    assert tool.main(argv + ["--device", "cpu"], **sizes) == 0
    out = capsys.readouterr().out
    for name in names:
        line = next(ln for ln in out.splitlines() if ln.startswith(name))
        assert "ok=False" not in line and " run " in line
    assert out.count("ok=True") == {t1: 4, t2: 1, t3: 3, t4: 0}[tool]


# ---------------- net_local and net_substage, modelled on the CPU ----------------


def _settle(lo, j, k, x, y):
    """keyed_network.cuh `settle_pair<false>` on int64 words key << 32 |
    source: the pair (lo, lo | j) holding x and y, key halves compared."""
    up = (lo & k) == 0
    kx, ky = x >> 32, y >> 32
    swap_lo = torch.where(up, kx > ky, ky > kx)
    swap_hi = ky > kx if k == j else swap_lo
    return torch.where(swap_lo, y, x), torch.where(swap_hi, x, y)


_WORDS = 1 << bn.LOCAL_REG_BITS


def _local_offsets(layout, threads):
    """[threads, words] tile offsets of each thread's words under a
    layout (the slot's register bits, lane bits 0-4, warp bits)."""
    t = torch.arange(threads)[:, None]
    slot = torch.arange(_WORDS)[None, :]
    lane, warp = t & 31, t >> 5
    e = torch.zeros(threads, _WORDS, dtype=torch.long)
    for f, b in enumerate(layout):
        src = slot >> f if f < bn.LOCAL_REG_BITS else (
            lane >> (f - bn.LOCAL_REG_BITS) if f < bn.LOCAL_MIN_BITS else warp >> (f - bn.LOCAL_MIN_BITS))
        e = e | ((src & 1) << b)
    return e


def _local_model(state, subs):
    """csrc/bitonic_net.cu `local_list` in plain torch, in its order of
    work: on each tile of `plan_local`, each thread's words loaded
    under layout 0; per substage either register pairs settling in place
    or one exchange with the lane whose bit is j, the pairs checked to be
    (i, i ^ j); a new layout through the tile in element order; then the
    keys from the words and every plane gathered through the sources."""
    plan = bn.plan_local(subs)
    p, n = state.shape
    tile = 1 << plan.bits
    threads = tile // _WORDS
    assert tile >= 2 * max([j for _, j in subs], default=1) and tile <= bn.TILE
    base = torch.arange(0, n, tile)[:, None, None]
    lane = torch.arange(threads) & 31
    e = _local_offsets(plan.layouts[0], threads)
    assert torch.equal(e.reshape(-1).sort().values, torch.arange(tile))
    w = (state[0].long()[base + e] << 32) | e
    flat = torch.empty(n // tile, tile, dtype=torch.long)
    cur = 0
    for (k, j), (li, kind, f) in zip(subs, plan.ops):
        if li != cur:  # a round through shared memory
            flat[:, e] = w
            cur, e = li, _local_offsets(plan.layouts[li], threads)
            w = flat[:, e]
        if kind == "reg":
            lo = [s for s in range(_WORDS) if not (s >> f) & 1]
            hi = [s | (1 << f) for s in lo]
            assert torch.equal(e[:, hi], e[:, lo] ^ j) and not (e[:, lo] & j).any()
            w[..., lo], w[..., hi] = _settle(base + e[:, lo], j, k, w[..., lo], w[..., hi])
        else:
            other = torch.arange(threads) ^ (1 << f)
            assert torch.equal(e[other], e ^ j)
            pw = w[:, other]
            upper = ((lane >> f) & 1).bool()[None, :, None]
            x, y = torch.where(upper, pw, w), torch.where(upper, w, pw)
            nx, ny = _settle(base + (e & ~j), j, k, x, y)
            w = torch.where(upper, ny, nx)
    flat[:, e] = w
    src = ((flat & 0xFFFFFFFF) + base[:, :, 0]).reshape(-1)
    return torch.cat([(flat >> 32).to(torch.int32).reshape(1, n), state[1:, src]])


def _local_lists(n):
    subs = bn.substages(n)
    return {
        "row C": [(32, 16)] * 136,
        "k <= 1024": [kj for kj in subs if kj[0] <= 1024],
        "mixed j < 1024": [kj for kj in bn.MIXED_SUBS if kj[1] < 1024],
        "k above the tile": [(n, j) for j in (128, 64, 32, 16, 8, 4, 2, 1)] + [(n // 2, 64)],
    }


@pytest.mark.parametrize("which", ["row C", "k <= 1024", "mixed j < 1024", "k above the tile"])
@pytest.mark.parametrize("p", [1, 3, 17])
@pytest.mark.parametrize("n", [1024, 4096, 1 << 16])
def test_local_model_equals_net_local_plain(n, p, which):
    """The new net_local's order of work equals the plain list on every
    plane, for keys with ties and for negative keys with both extremes."""
    subs = _local_lists(n)[which]
    rng = np.random.default_rng(90 + p)
    for keys in ("ties", "negative"):
        st = rng.integers(-2**31, 2**31 - 1, (p, n)).astype(np.int32)
        st[0] = _keys(keys, n, rng)
        state = torch.from_numpy(st)
        assert torch.equal(_local_model(state, subs), bn.net_local_plain(state, subs)), keys


def test_local_plan_layouts():
    """Row C runs in one layout with j = 16 a register bit on 256-element
    tiles (256 of them at n = 65,536); the k <= 1024 list and the host
    walk's lists change layout a few times on 1024-element tiles."""
    lists = _local_lists(1 << 16)
    c = bn.plan_local(lists["row C"])
    assert c.bits == bn.LOCAL_MIN_BITS == 8 and len(c.layouts) == 1
    assert 4 in c.layouts[0][:bn.LOCAL_REG_BITS]
    assert all(kind == "reg" for _, kind, _ in c.ops)
    small = bn.plan_local(lists["k <= 1024"])
    assert small.bits == 10 and len(small.layouts) == 4
    walk = [kj for kj in bn.substages(1 << 16) if kj[0] == 1 << 16 and kj[1] < 1024]
    assert len(bn.plan_local(walk).layouts) == 2
    assert bn.plan_local([]).layouts == (tuple(range(bn.LOCAL_MIN_BITS)),)
    codes, layouts = bn.local_plan_codes(lists["k <= 1024"])
    assert sum(1 for c in codes if c & bn.LOCAL_NEW_LAYOUT) == len(layouts) == 4


def _substage_model(state, k, j):
    """csrc/bitonic_net.cu `exchange` in plain torch: thread q owns the
    16-byte-aligned runs of four at b0 and b1 = b0 + max(j, 4), which hold
    pairs 4q .. 4q + 3 (for j in {1, 2} the chunk 8q .. 8q + 7), slot m
    paired with slot m ^ min(j, 4)."""
    n = state.shape[1]
    q = torch.arange(n // 8)[:, None]
    jj = max(j, 4)
    b0 = 8 * q - ((4 * q) & (jj - 1))
    m = torch.arange(8)[None, :]
    idx = torch.where(m < 4, b0, b0 + jj) + (m & 3)
    assert torch.equal(idx.reshape(-1).sort().values, torch.arange(n))
    assert not (b0 % 4).any() and not ((b0 + jj) % 4).any()
    perm = [s ^ min(j, 4) for s in range(8)]
    assert torch.equal(idx[:, perm], idx ^ j)
    key = state[0][idx]
    take_min = ((idx & j) == 0) == ((idx & k) == 0)
    swap = torch.where(take_min, key > key[:, perm], key < key[:, perm])
    out = torch.empty_like(state)
    for p in range(state.shape[0]):
        v = state[p][idx]
        out[p][idx] = torch.where(swap, v[:, perm], v)
    return out


@pytest.mark.parametrize("n", [1024, 4096])
def test_substage_model_equals_net_substage_plain(n):
    """The vector mapping of net_substage, four pairs per thread, for
    every j from 1 to n / 2 with k above, equal to and below j."""
    st = _input(3, n, seed=91)
    st[0, ::7] = np.iinfo(np.int32).min
    state = torch.from_numpy(st)
    for lj in range(n.bit_length() - 1):
        j = 1 << lj
        for k in sorted({min(2 * j, n), j, n, max(1, j // 4)}):
            assert torch.equal(_substage_model(state, k, j), bn.net_substage_plain(state, k, j)), (k, j)
