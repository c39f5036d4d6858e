"""The port's block-variant bench (S1) against ``scripts/bench_block_variants.py``,
on the CPU at a tiny geometry.

The script is loaded from its file with its module constants patched to
B=4, LP=16, L=13, D=64 with H=2 (dh=32, where q rounded to bf16 differs
from q in fp32) or H=1 (dh=64, where the bf16 scale 0.125 is exact), and
12 layers.  Its Pallas bodies run two ways: op by op under
``jax.disable_jit()`` with stand-in refs, where every ``.astype`` rounds,
and through ``pl.pallas_call(..., interpret=True)``, which XLA compiles and
where it keeps excess precision across the bf16 casts (ROADMAP.md queue
3).  The micro kernels are closures, captured by a ``pl.pallas_call`` that
records them and runs them in interpret mode.  On the CPU the port's
wrappers run their plain versions; the CUDA kernels are held to those on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import contextlib
import importlib.util
import io
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from protoclip_tpu_torch.ops import block_variants as bv
from protoclip_tpu_torch.ops import kernels
from protoclip_tpu_torch.scripts import bench_block_variants as bench

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "bench_block_variants.py"
TINY = dict(B=4, LP=16, L=13, D=64, H=2, LAYERS=12, G=2)
NAMES = ("v0 v1 v2 v3 v4 v5 v6 v6g8 v7 v9 v2g8 v2g32 v10 int8 int8g8 int8g32 int8h int8gb "
         "int8noattn int8static int8recip int8cast int8lnb int8s int8sg8 micro:mlp_xla "
         "micro:mlp_pallas micro:int8mlp micro:int8mlp_nogelu micro:int8mlp_fp32gelu "
         "micro:int8qkv micro:attn_pallas micro:attn_nosm micro:attn_noqkv").split()
_ORIG_PALLAS_CALL = pl.pallas_call


def _load_script(name="bbv_ref"):
    spec = importlib.util.spec_from_file_location(name, SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    """The script at the tiny geometry, its pallas_call in interpret mode
    and recording each kernel it is given."""
    mod = _load_script()
    for key, value in TINY.items():
        setattr(mod, key, value)
    mod.DH = TINY["D"] // TINY["H"]
    mod.kernels = []

    def interpret_call(kernel, **kw):
        mod.kernels.append(kernel)
        kw.pop("compiler_params", None)
        kw["interpret"] = True
        return _ORIG_PALLAS_CALL(kernel, **kw)

    mod.pl = type("pl", (), {"pallas_call": staticmethod(interpret_call),
                             "BlockSpec": staticmethod(pl.BlockSpec)})
    return mod


def geom(h=TINY["H"], length=TINY["L"], padded=TINY["LP"]):
    return bv.Geometry(TINY["B"], length, padded, TINY["D"], h, TINY["LAYERS"], TINY["G"])


def f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def np32(t):
    return t.detach().float().numpy()


def jx(t):
    """A port tensor as the JAX array of the same dtype."""
    dt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32, torch.int8: jnp.int8}
    return jnp.asarray(t.float().numpy()).astype(dt[t.dtype])


def rel_cos(ours, ref_):
    a, b = np.ravel(ours).astype(np.float64), np.ravel(ref_).astype(np.float64)
    return np.abs(a - b).max() / np.abs(b).max(), float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def assert_bars(ours, ref_, rel, cos):
    r, c = rel_cos(ours, ref_)
    assert r < rel and c > cos, (r, c)


class _Ref:
    """A stand-in for a Pallas ref, so a kernel body runs as plain jnp;
    it honours the body's slices (v3 reads its weights in chunks)."""

    def __init__(self, value=None):
        self.value = value

    def __getitem__(self, idx):
        return self.value[idx]

    def __setitem__(self, idx, value):
        self.value = value


def op_by_op(kernel, x, args):
    """A Pallas body run eagerly, one jnp op at a time."""
    out = _Ref()
    with jax.disable_jit():
        kernel(_Ref(x), *map(_Ref, args), out)
    return out.value


def interpret(kernel, x, args):
    """One block through pl.pallas_call in interpret mode, as one grid step."""
    return _ORIG_PALLAS_CALL(kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
                             interpret=True)(x, *args)


# -- the grammar and the host helpers --------------------------------------------------------


def test_parser_matches_the_scripts_main(ref, monkeypatch, capsys):
    """Every name of the chip list, ``int8sstatic`` and ``v10 v10`` reach
    the same entries with the same arguments in both packages."""
    names = NAMES + ["int8sstatic", "v10", "v1"]
    calls = []
    monkeypatch.setattr(ref, "_enable_cache", lambda: None)
    monkeypatch.setattr(ref, "bench_micro", lambda which: calls.append(("micro", which)))
    monkeypatch.setattr(ref, "bench_int8", lambda **kw: calls.append(("int8", kw)))
    monkeypatch.setattr(ref, "fold_ln_into_weights", lambda w: calls.append(("fold",)) or w)

    def build_stack_fn(variant, g):
        calls.append(("stack", variant, g))
        return lambda x, w: np.float32(0)

    monkeypatch.setattr(ref, "build_stack_fn", build_stack_fn)
    monkeypatch.setattr("sys.argv", ["bench_block_variants.py", *names])
    ref.main()
    capsys.readouterr()
    ours = []
    for name in names:
        spec = bench.parse_variant(name, geom())
        if spec["kind"] == "micro":
            ours.append(("micro", spec["which"]))
        elif spec["kind"] == "int8":
            ours.append(("int8", {k: v for k, v in spec.items() if k != "kind"}))
        else:
            ours += [("fold",)] * spec["fold"] + [("stack", spec["variant"], spec["g"])]
    assert ours == calls
    assert calls.count(("fold",)) == 2
    assert bench.twin(bench.parse_variant("int8sstatic", geom()), geom()) == "int8static"


@pytest.mark.parametrize("env,want", [({}, (512, 197, 200, 768, 12)),
                                      ({"BENCH_GEOM": "vitl"}, (128, 257, 264, 1024, 16)),
                                      ({"BENCH_GEOM": "vitl", "BENCH_LP16": "1"},
                                       (128, 257, 272, 1024, 16))])
def test_geometry_matches_the_scripts_constants(monkeypatch, env, want):
    for key in ("BENCH_GEOM", "BENCH_LP16"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    mod = _load_script("bbv_geom")
    g = bv.geometry()
    assert (g.batch, g.length, g.padded, g.width, g.heads) == (mod.B, mod.L, mod.LP, mod.D, mod.H)
    assert (g.batch, g.length, g.padded, g.width, g.heads) == want
    assert (g.layers, g.group) == (mod.LAYERS, mod.G)


def test_draws_and_host_helpers_are_bit_identical(ref):
    rng = np.random.default_rng(0)
    x_ref, w_ref = jnp.asarray(rng.standard_normal((4, 16, 64)) * 0.1, jnp.bfloat16), ref.make_weights(rng)
    x, w = bv.main_draws(geom())
    np.testing.assert_array_equal(np32(x), f32(x_ref))
    assert len(w) == len(w_ref) == 12
    for ours, theirs in zip(w, w_ref):
        assert ours.dtype == {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}[theirs.dtype.type]
        np.testing.assert_array_equal(np32(ours), f32(theirs))
    for ours, theirs in zip(bv.fold_ln_into_weights(w), ref.fold_ln_into_weights(w_ref)):
        np.testing.assert_array_equal(np32(ours), f32(theirs))
    # bench_micro's own draws after x (:414-416, :553-555)
    for family, shapes in (("mlp", ((64, 256), (256, 64))), ("qkv", ((64, 192), (64, 64)))):
        rng = np.random.default_rng(0)
        rng.standard_normal((4, 16, 64))
        draws = bv.micro_draws(geom(), family)
        for ours, shape in zip(draws[1:], shapes):
            np.testing.assert_array_equal(
                np32(ours), f32(jnp.asarray(rng.standard_normal((12, *shape)) * 0.02, jnp.bfloat16)))
    for i in (0, 11):
        q, s = bv.quant_cols_host(np32(w[8][i]))
        jq, js = ref._quant_cols_host(w_ref[8][i])
        np.testing.assert_array_equal(q, np.asarray(jq))
        np.testing.assert_array_equal(s, np.asarray(js))
        tq, ts = bv.quant_layer(w[8][i])
        np.testing.assert_array_equal(tq.numpy(), q.T)
        np.testing.assert_array_equal(ts.numpy(), s.reshape(-1))


# -- S1.a: the bf16 block variants ------------------------------------------------------------

_BF16_ORDER = ("wqkv", "bqkv", "wo", "bo", "ln1s", "ln1b", "ln2s", "ln2b",
               "wfc", "bfc", "wproj", "bproj")


def _bf16_case(variant, h):
    g = geom(h)
    x, w = bv.main_draws(g)
    if variant == "v10":
        w = bv.fold_ln_into_weights(w)
    layer = tuple(t[0] for t in w)
    spec = bench.parse_variant(variant, g)
    q_round, gelu_bf16, folded = bench._stack_key(variant)
    ours = bv.block_bf16(x, layer, h, g.length, q_round, gelu_bf16, folded)
    return x, layer, spec, np32(ours)


@pytest.mark.parametrize("h", [2, 1])
@pytest.mark.parametrize("variant", ["v0", "v1", "v2", "v3", "v4", "v5", "v6", "v7", "v9", "v10"])
def test_bf16_variant_block_matches_its_pallas_body(ref, variant, h):
    """Each variant's plain block (its twin's chain) against the script's
    body for that variant run op by op: the same cast points, so the same
    bf16 outputs.  The fp32 sums (LayerNorm, scores, products) run in
    another order on the two sides; at these inputs that moves no output."""
    x, layer, _, ours = _bf16_case(variant, h)
    kernel = ref.make_kernel(variant, h, TINY["L"])
    body = f32(op_by_op(kernel, jx(x), [jx(t) for t in layer]))
    np.testing.assert_array_equal(ours, body)


@pytest.mark.parametrize("h", [2, 1])
def test_q_round_attention_matches_the_body_loop(h):
    """The ``q_round`` scores: T(q * T(dh^-0.5)) as JAX rounds the weakly
    typed scale to bf16 (:212).  At dh=64 the scale 0.125 is exact and the
    mode is the fp32 one bit for bit; at dh=32 it is not."""
    rng = np.random.default_rng(1)
    l, d = TINY["LP"], TINY["D"]
    qkv = rng.standard_normal((2, l, 3 * d)).astype(np.float32)
    tq = torch.from_numpy(qkv).to(torch.bfloat16)
    sl = (tq[..., :d], tq[..., d:2 * d], tq[..., 2 * d:])
    ours = kernels.fused_attention_packed_plain(*sl, h, False, TINY["L"], "q_round")
    plain = kernels.fused_attention_packed_plain(*sl, h, False, TINY["L"])
    assert torch.equal(ours, plain) == (h == 1)
    jq = jnp.asarray(qkv, jnp.bfloat16)
    dh = d // h
    with jax.disable_jit():
        for i in range(h):
            qh = jq[:, :, i * dh:(i + 1) * dh] * dh ** -0.5
            s = jax.lax.dot_general(qh, jq[:, :, d + i * dh:d + (i + 1) * dh],
                                    (((2,), (2,)), ((0,), (0,))),
                                    preferred_element_type=jnp.float32)
            qs = (sl[0][..., i * dh:(i + 1) * dh] * kernels._const(dh ** -0.5, sl[0])).float()
            np.testing.assert_array_equal(f32(qh), np32(qs))
            np.testing.assert_allclose(np32(qs @ sl[1][..., i * dh:(i + 1) * dh].float()
                                            .transpose(1, 2)), f32(s), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("variant", ["v0", "v1", "v2", "v10"])
def test_bf16_variant_block_matches_pallas_interpret(ref, variant):
    """Against the interpret-mode call, at the card's bf16 bars."""
    x, layer, _, ours = _bf16_case(variant, 2)
    kernel = ref.make_kernel(variant, 2, TINY["L"])
    assert_bars(ours, f32(interpret(kernel, jx(x), [jx(t) for t in layer])), 1e-2, 0.9999)


# -- S1.b-e: the micro kernels, captured ----------------------------------------------------------

MICRO = ("mlp_pallas", "int8mlp", "int8mlp_nogelu", "int8mlp_fp32gelu", "int8qkv",
         "attn_pallas", "attn_nosm", "attn_noqkv")


def _script_args(which, layer):
    """The port's layer as the captured kernel's operands: int8 matrices
    back to (in, out), scales to (1, out)."""
    t = [jx(a) for a in layer]
    if which.startswith("int8"):
        t[0], t[1], t[3], t[4] = t[0].T, t[1][None], t[3].T, t[4][None]
    return t


def _run_captured(ref, run):
    ref.kernels.clear()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run()
    checksum = float(re.search(r"checksum (-?[0-9.]+)", out.getvalue()).group(1))
    return ref.kernels[0], checksum


def assert_checksum_close(ours_out, ours_cs, ref_cs):
    """12 layers of bf16 roundings that XLA, compiling the interpret-mode
    call, partly skips (ROADMAP.md queue 3): the checksums, sums of 4096
    outputs, agree to 1e-3 of the outputs' absolute sum (the script prints
    two decimals)."""
    assert abs(ours_cs - ref_cs) <= 1e-3 * float(ours_out.float().abs().sum()) + 0.005, (
        ours_cs, ref_cs)


@pytest.mark.parametrize("which", MICRO)
def test_micro_block_matches_its_captured_kernel(ref, which):
    """S1.b-e: one layer of the port's plain micro block against the
    script's own closure run op by op, bit for bit, and the 12-layer
    checksum against the script's interpret-mode stack."""
    kernel, ref_cs = _run_captured(ref, lambda: ref.bench_micro(which))
    prep = bench.prepare("micro:" + which, bench.parse_variant("micro:" + which, geom()), geom(),
                         "cpu")
    ours = np32(prep.block(prep.x, prep.layers[0], bv.PLAIN_OPS))
    body = f32(op_by_op(kernel, jx(prep.x), _script_args(which, prep.layers[0])))
    np.testing.assert_array_equal(ours, body)
    out = bench.stack_output(prep, bv.PLAIN_OPS)
    assert_checksum_close(out, float(out.float().sum()), ref_cs)


def test_micro_mlp_xla_matches_the_script(ref):
    """micro:mlp_xla is plain XLA in the script and plain PyTorch here."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ref.bench_micro("mlp_xla")
    ref_cs = float(re.search(r"checksum (-?[0-9.]+)", out.getvalue()).group(1))
    prep = bench.prepare("micro:mlp_xla", bench.parse_variant("micro:mlp_xla", geom()), geom(),
                         "cpu")
    ours = bench.stack_output(prep, bv.PLAIN_OPS)
    assert_checksum_close(ours, float(ours.float().sum()), ref_cs)


# -- S1.f: the int8 block variants and the int8 attention core ------------------------------------

INT8_VARIANTS = ("int8", "int8h", "int8gb", "int8noattn", "int8static", "int8recip", "int8cast",
                 "int8lnb")
_INT8_KERNEL_ARGS = ("quant_hid", "skip_attn", "gelu_bf16", "static_scales", "quant_mode",
                     "ln_stats_bf16")


def _int8_case(name, h=2, group=None, g=None):
    g = g or geom(h)
    spec = bench.parse_variant(name, g)
    flags = bench._int8_flags(spec)
    layer = bench._int8_host_layers(g, not flags["quant_hid"])[0]
    x = bv.main_draws(g)[0]
    ours = bv.block_int8(x, layer, h, g.length, group=group or spec["g"], ops=bv.PLAIN_OPS,
                         **flags)
    return x, layer, spec, np32(ours)


def _int8_script_args(layer):
    """``bench_int8``'s operands (:958-961): int8 matrices (in, out), scales
    (1, out)."""
    t = [jx(a) for a in layer[:16]]
    for i in (0, 3, 10, 13):
        t[i], t[i + 1] = t[i].T, t[i + 1][None]
    return t


@pytest.mark.parametrize("name,h", [(n, 2) for n in INT8_VARIANTS] + [("int8", 1)])
def test_int8_variant_block_matches_its_pallas_body(ref, name, h):
    """S1.f: each int8 variant's plain block against ``make_kernel_int8``'s
    body with the same flags, run op by op: bit-identical at these inputs
    (the LayerNorm sums run in another order and could move an int8 code
    on a rounding tie; here none moves)."""
    x, layer, spec, ours = _int8_case(name, h)
    kernel = ref.make_kernel_int8(h, TINY["L"], **{k: spec[k] for k in _INT8_KERNEL_ARGS})
    body = f32(op_by_op(kernel, jx(x), _int8_script_args(layer)))
    np.testing.assert_array_equal(ours, body)


@pytest.mark.parametrize("name", ["int8", "int8h", "int8lnb", "int8cast"])
def test_int8_variant_block_matches_pallas_interpret(ref, name):
    """Against the interpret-mode call, at the card's int8 block bars."""
    x, layer, spec, ours = _int8_case(name)
    kernel = ref.make_kernel_int8(2, TINY["L"], **{k: spec[k] for k in _INT8_KERNEL_ARGS})
    assert_bars(ours, f32(interpret(kernel, jx(x), _int8_script_args(layer))), 2e-2, 0.9999)


@pytest.mark.parametrize("h,padded,length", [
    pytest.param(2, TINY["LP"], TINY["L"], id="2"), pytest.param(1, TINY["LP"], TINY["L"], id="1"),
    # rows L that are no multiple of the tensor-core kernel's 16-row and
    # 32-key tiles, with keys masked from length on
    pytest.param(2, 13, 9, id="2-L13-len9"), pytest.param(2, 17, 11, id="2-L17-len11"),
    pytest.param(2, 40, 33, id="2-L40-len33"), pytest.param(1, 24, 20, id="1-L24-len20")])
def test_int8s_groups_its_v_scale_by_the_grid_block(ref, h, padded, length):
    """``int8s``: the script's body quantizes v with one amax per head over
    its grid block of g batch elements (:1047).  The port's block with
    ``group=g`` equals the body run op by op on each block of g, at g=2 and
    g=4, and the two groupings give different outputs."""
    kernel = ref.make_kernel_int8s(h, length)
    gm = geom(h, length, padded)
    outs = {}
    for g in (2, 4):
        x, layer, _, ours = _int8_case("int8s", h, group=g, g=gm)
        args = _int8_script_args(layer)
        body = np.concatenate([f32(op_by_op(kernel, jx(x[i:i + g]), args))
                               for i in range(0, TINY["B"], g)])
        np.testing.assert_array_equal(ours, body)
        outs[g] = ours
    assert not np.array_equal(outs[2], outs[4])
    x, layer, _, _ = _int8_case("int8s", h, group=4, g=gm)
    assert_bars(outs[4], f32(interpret(kernel, jx(x), _int8_script_args(layer))), 2e-2, 0.9999)


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(batch=st.integers(1, 4), n_head=st.integers(1, 2), rows=st.integers(1, 40),
       data=st.data())
def test_attention_int8_plain_codes_the_tensor_core_kernel_relies_on(batch, n_head, rows, data):
    """Three facts of ``attention_int8_plain`` that ``csrc/attention_int8.cu``
    builds on: the weight codes w_q lie in [0, 127] (they fit s8 and are
    packed into the PV product as they are), keys at or past ``length`` get
    code 0 (so the key padding of the 32-key steps adds nothing), and every
    batch element of a group shares one v scale per head.  v is a scaled
    identity (v[b, j, head*dh + j] = c_b), so each output column is one
    weight code times one v code: o = w_q * round(127 c_b / A) * A / 127^2
    with A the group's largest c."""
    length = data.draw(st.integers(1, rows), label="length")
    group = data.draw(st.sampled_from([g for g in (1, 2, 4) if batch % g == 0]), label="group")
    seed = data.draw(st.integers(0, 2 ** 16), label="seed")
    rng = np.random.default_rng(seed)
    dh = -(-rows // 8) * 8
    d = n_head * dh
    q, k = (torch.from_numpy(rng.standard_normal((batch, rows, d)).astype(np.float32) * 2)
            for _ in range(2))
    eye = torch.zeros(rows, dh)
    eye[torch.arange(rows), torch.arange(rows)] = 1.0
    c = torch.from_numpy(rng.uniform(0.25, 4.0, batch).astype(np.float32))
    v = (c[:, None, None] * eye).repeat(1, 1, n_head)
    # w_q from the unit identity with no grouping: o * 127 = w_q exactly
    o1 = kernels.attention_int8_plain(q, k, eye.repeat(batch, 1, n_head), n_head, length, 1)
    w = (o1 * 127.0).reshape(batch, rows, n_head, dh)[..., :rows]
    w_q = torch.round(w)
    assert float((w - w_q).abs().max()) < 1e-4
    assert float(w_q.min()) >= 0 and float(w_q.max()) <= 127
    assert bool((w_q[..., length:] == 0).all())
    # one scale per head for each group: the group's largest c
    a = c.reshape(-1, group).amax(dim=1).repeat_interleave(group)[:, None, None, None]
    code = torch.round(c[:, None, None, None] * (127.0 / a))
    want = (w_q * code) * (a / torch.tensor(16129.0))
    got = kernels.attention_int8_plain(q, k, v, n_head, length, group)
    assert torch.equal(got.reshape(batch, rows, n_head, dh)[..., :rows], want)


# -- 12-layer checksums, the CLI, the wrappers ---------------------------------------------------


def _fewer_timing_runs(monkeypatch, ref):
    """The script times 8 calls after the first; one will do here.  Only
    its timing loops take range(8) at this geometry."""
    import builtins

    monkeypatch.setattr(ref, "range", lambda *a: builtins.range(1) if a == (8,)
                        else builtins.range(*a), raising=False)


@pytest.mark.parametrize("name", ["v0", "v2", "v10", "int8", "int8h", "int8gb", "int8noattn",
                                  "int8static", "int8recip", "int8cast", "int8lnb", "int8s"])
def test_stack_checksum_matches_the_scripts_stack(ref, monkeypatch, name):
    """Each family's 12-layer checksum against the script's stack in
    interpret mode, with a grid block of g=2 (int8s's v scale groups)."""
    _fewer_timing_runs(monkeypatch, ref)
    g = geom()
    spec = bench.parse_variant(name, g)
    if spec["kind"] == "stack":
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.standard_normal((4, 16, 64)) * 0.1, jnp.bfloat16)
        w = ref.make_weights(rng)
        if name == "v10":
            w = ref.fold_ln_into_weights(w)
        ref_cs = float(ref.build_stack_fn(name, TINY["G"])(x, w))
        prep = next(bench.iter_prepared([name], g, "cpu"))
    else:
        kw = {k: v for k, v in spec.items() if k not in ("kind", "g")}
        gg = TINY["G"]  # the grid block; it matters only to int8s
        _, ref_cs = _run_captured(ref, lambda: ref.bench_int8(g=gg, **kw))
        prep = bench.prepare(name, dict(spec, g=gg), g, "cpu")
    out = bench.stack_output(prep, bv.PLAIN_OPS)
    assert_checksum_close(out, float(out.float().sum()), ref_cs)


def test_cli_runs_on_the_cpu_and_needs_the_card_otherwise(monkeypatch, capsys):
    g = bv.Geometry(16, 13, 16, 64, 2, 12, 2)
    monkeypatch.setattr(bv, "geometry", lambda env=None: g)
    monkeypatch.setattr(bench, "RUNS", 1)
    kernels.reset_launch_counts()
    assert bench.main(["--device", "cpu", "v0", "v2", "int8", "int8s", "micro:attn_nosm"]) == 0
    lines = capsys.readouterr().out.strip().split("\n")
    pattern = [r"v0: [0-9.]+ ms/12-block-stack  \(checksum -?[0-9.]+, compile \d+s, g=2\)",
               r"v2: [0-9.]+ ms/12-block-stack  \(checksum -?[0-9.]+, compile \d+s, g=2\)",
               r"int8\(g=16\): [0-9.]+ ms/12-block-stack \(checksum -?[0-9.]+, compile \d+s\)",
               r"int8s\(g=16\): [0-9.]+ ms/12-block-stack \(checksum -?[0-9.]+, compile \d+s\)",
               r"attn_nosm: [0-9.]+ ms/12-layer  \(checksum -?[0-9.]+, compile \d+s\)"]
    assert len(lines) == len(pattern)
    for line, pat in zip(lines, pattern):
        assert re.fullmatch(pat, line), line
    assert set(kernels.launch_counts().values()) == {0}  # plain versions only
    with pytest.raises(SystemExit, match="do not support"):
        bench.main(["--device", "cpu", "int8slnb"])
    with pytest.raises(SystemExit, match="unknown micro"):
        bench.main(["--device", "cpu", "micro:nothing"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench.main(["v0"])


def test_v10_keeps_its_folded_weights_for_later_variants():
    """As the script's main (:384-385): ``v10 v10`` folds twice, and a bf16
    variant after v10 runs on folded weights."""
    g = geom()
    w = bv.main_draws(g)[1]
    once, twice = bv.fold_ln_into_weights(w), bv.fold_ln_into_weights(bv.fold_ln_into_weights(w))
    preps = list(bench.iter_prepared(["v0", "v10", "v10", "v0", "int8"], g, "cpu"))
    assert torch.equal(preps[0].layers[0][0], w[0][0])
    assert torch.equal(preps[1].layers[0][0], once[0][0])
    for p in preps[2:4]:
        assert torch.equal(p.layers[0][0], twice[0][0]) and torch.equal(p.layers[0][1], twice[1][0])
    assert not torch.equal(once[0][0], twice[0][0])
    assert preps[4].spec["kind"] == "int8"  # bench_int8 draws its own weights


def test_bench_wrappers_take_plain_versions_on_cpu(rng):
    x = torch.from_numpy(rng.standard_normal((2, 16, 3 * 64)).astype(np.float32))
    sl = (x[..., :64], x[..., 64:128], x[..., 128:])
    kernels.reset_launch_counts()
    for mode in ("q_round", "no_softmax"):
        assert torch.equal(kernels.attention_packed(*sl, 2, False, 13, mode),
                           kernels.fused_attention_packed_plain(*sl, 2, False, 13, mode))
    assert torch.equal(kernels.attention_int8(*sl, 2, 13, 2),
                       kernels.attention_int8_plain(*sl, 2, 13, 2))
    assert torch.equal(kernels.qkv_sum(x), kernels.qkv_sum_plain(x))
    for mode in ("recip", "static", "cast"):
        for got, want in zip(kernels.quant_rows(x, mode), kernels.quant_rows_plain(x, mode)):
            assert torch.equal(got, want)
    assert set(kernels.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="unknown attention mode"):
        kernels.attention_packed(*sl, 2, mode="sigmoid")
    with pytest.raises(ValueError, match="unknown quantizer"):
        kernels.quant_rows(x, "floor")
    with pytest.raises(ValueError, match="multiple of group"):
        kernels.attention_int8(*sl, 2, 13, 3)
    with pytest.raises(ValueError, match="residual"):
        kernels.gemm_bias_epilogue(x, torch.zeros(192, 8), torch.zeros(8), "bias32_residual")


def test_quantizer_modes_match_the_script(ref):
    """recip, static and cast (:758-791) against the script's, bit for bit,
    including NaN, infinities, exact ties and the +-128 saturation of cast."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((6, 64)) * 3).astype(np.float32)
    x[0, :8] = [np.nan, np.inf, -np.inf, 4.0, -4.1, 0.5 / 32, 1.5 / 32, -2.5 / 32]
    x[1] = 0.0
    for mode in ("recip", "static", "cast"):
        q, s = kernels.quant_rows_plain(torch.from_numpy(x), mode)
        if mode == "recip":
            finite = np.isfinite(x).all(axis=1)
            jq, js = ref._quant_rows_recip(jnp.asarray(x[finite]))
            np.testing.assert_array_equal(q.numpy()[finite], np.asarray(jq))
            np.testing.assert_array_equal(s.numpy()[finite], np.asarray(js))
            continue
        with jax.disable_jit():  # the closures of make_kernel_int8, :777-781 and :788-791
            xf = jnp.asarray(x)
            jq = (jnp.clip(jnp.round(xf * 32.0), -127, 127).astype(jnp.int8) if mode == "static"
                  else (xf * 32.0).astype(jnp.int8))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert torch.all(s == 1 / 32)
