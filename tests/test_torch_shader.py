"""The rusteria shader compiler in torch (`rusterix_tpu_torch/shader/jaxc.py`)
against the JAX package's (`rusterix_tpu/shader/jaxc.py`) on the CPU.

- The programs of tests/test_shader_lang.py, inline: scalar scripts through
  `Program.run` (the last value), shaders through `Program.shade` on one
  seeded uv grid (every register; the JAX side inside `jax.jit`, as its
  bakes run, the port's evaluator with `traced=True`). Tolerance: allclose
  at atol 1e-5 (XLA fuses the shaders' `a*b + c`, and its CPU sin, pow and
  exp are not torch's); `input_loads`, `uses_time`, `supports_opacity`
  equal.
- The wood shader's `bake_state` at 128², and a texture script's
  alloc / iterate / save through `execute_script`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rusterix_tpu.shader import jaxc as jx  # noqa: E402
from rusterix_tpu_torch.shader import jaxc as tx  # noqa: E402
from rusterix_tpu_torch.scenes import WOOD_SHADER  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIB = """
fn fib(n) {
    if n <= 1 {
        return n;
    } else {
        return fib(n - 1) + fib(n - 2);
    }
}
fib(12);
"""

CLASSIFY = """
fn classify(x) {
    if x < 0 {
        return 0 - 1;
    } else if x == 0 {
        return 0;
    } else {
        return 1;
    }
}
classify(5) + classify(0) * 10 + classify(0-3);
"""

FOR_STATIC = """
let total = 0;
for (let i = 0; i < 6; i += 1) {
    total += i;
}
total;
"""

LANG_WOOD = """
fn shade() {
    let t = time * 0.0;
    let uv2 = uv / 3.0 - vec2(1.5);
    let n1 = sample(uv2 + vec2(t, 0.0), "fbm_perlin");
    let n2 = sample(uv2 * 2.0 + vec2(0.0, t*0.7), "fbm_perlin");
    let turb = 0.65 * n1 + 0.35 * n2;
    let turb_zm = (turb - 0.5) * 2.0;
    let r = length(uv2);
    let rings = r + 0.22 * turb_zm;
    let waves = sin(rings * 10.0);
    let rings_mask = pow(1.0 - abs(waves), 3.0);
    let grain_uv = vec2(uv2.x * 8.0, uv2.y * 40.0);
    let g = sample(grain_uv + vec2(0.0, t*0.5), "value");
    let grain = (g - 0.5) * 2.0;
    color = mix(vec3(0.72, 0.52, 0.32), vec3(0.45, 0.30, 0.16), rings_mask);
    color *= (1.0 + 0.06 * grain);
    let band = uv2.y + 0.15 * turb_zm;
    let cathedral = pow(1.0 - abs(sin(band * 6.0)), 4.0);
    color = mix(color, color * 0.9, cathedral * 0.2);
    roughness = 0.6 + cathedral * 0.3;
}
"""

# (kind, source): "run" compares Program.run's last value, "shade" every
# register of Program.shade over the seeded grid
PROGRAMS = {
    "addition": ("run", "let a = 2; a + 2;"),
    "fib": ("run", FIB),
    "ternary_true": ("run", "let flag = 1; flag ? 10 : 20;"),
    "ternary_false": ("run", "let flag = 0; flag ? 10 : 20;"),
    "swizzle_read": ("run", "let v = vec3(1, 2, 3); v.zyx.x;"),
    "swizzle_write": ("run", "let v = vec3(1, 2, 3); v.xy = vec2(7, 8); v.y;"),
    "dot2": ("run", "dot(vec2(1, 2), vec2(3, 4));"),
    "length_cross_normalize": (
        "run", "length(vec2(3, 4)) + cross(vec3(1,0,0), vec3(0,1,0)).z "
               "+ normalize(vec2(10, 0)).x;"),
    "mod": ("run", "-1.5 % 1.0;"),
    "fract": ("run", "fract(-0.25);"),
    "clamp_mix_step": ("run", "clamp(5, 0, 1) + mix(0, 10, 0.5) + step(0.5, 0.7);"),
    "smoothstep_pow": ("run", "smoothstep(0, 1, 0.5) + pow(2, 10);"),
    "min_max_rounding": ("run", "min(3, 4) + max(3, 4) + floor(1.7) + ceil(1.2) + round(0.5);"),
    "for_static": ("run", FOR_STATIC),
    "if_else_chain": ("run", CLASSIFY),
    "compound_assignment": ("run", "let a = 10; a /= 2; a -= 1; a *= 3; a;"),
    "registers": ("shade", """
        fn shade() {
            color = vec3(uv.x, uv.y, 0.5);
            roughness = 0.25;
            opacity = 0.5;
        }"""),
    "sample_patterns": ("shade", """
        fn shade() {
            let n = sample(uv * 4.0, "fbm_perlin");
            let b = sample(uv * 2.0, "bricks");
            color = vec3(n.x, b.x, sample(uv, "perlin").x);
        }"""),
    "vector_ops": ("shade", """
        fn shade() {
            let p = vec3(uv.x, uv.y, uv.x * uv.y) - vec3(0.5);
            let q = normalize(cross(p, vec3(0.2, 1.0, 0.3)));
            color = abs(q) * dot(p, q) + vec3(length(p.xy));
            normal = vec3(rotate2d(p.xy, uv.x * 3.0), 1.0);
        }"""),
    "branches_and_loops": ("shade", """
        fn shade() {
            let acc = 0.0;
            for (let i = 0; i < 4; i += 1) {
                acc += sin(uv.x * i) * 0.25;
            }
            if uv.y > 0.5 {
                color = vec3(acc, 0.2, 0.1);
            } else if uv.x < 0.3 {
                color = vec3(0.1, acc, 0.2);
            } else {
                color = vec3(0.3, 0.3, acc);
            }
            metallic = uv.x > uv.y ? 1.0 : 0.0;
            emissive.x = fract(uv.x * 5.0);
            match floor(uv.x * 3.0) {
                0 { bump = 0.5; }
                1 { bump = 0.25; }
                _ { bump = 0.75; }
            }
            let w = 0.0;
            while w < uv.y { w += 0.5; }
            opacity = w;
        }"""),
    "wood": ("shade", LANG_WOOD),
}

N = 24  # the seeded grid is N x N


def _grid():
    """Register inputs over an N x N grid made from a numpy seed."""
    rng = np.random.default_rng(7)
    uv = rng.uniform(-2.0, 3.0, (N, N, 2)).astype(np.float32)
    zeros = np.zeros((N, N, 3), np.float32)
    state = {k: zeros for k in ("color", "metallic", "emissive", "bump", "normal", "hitpoint")}
    state.update({
        "uv": np.concatenate([uv, zeros[..., :1]], axis=-1),
        "roughness": zeros + 0.5, "opacity": zeros + 1.0, "time": zeros + 0.375,
    })
    return state


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_program_matches_jax_evaluator(name):
    kind, src = PROGRAMS[name]
    pj = jx.Program(jx.parse(src))
    pt = tx.Program(tx.parse(src))
    assert pt.input_loads == pj.input_loads
    assert (pt.uses_time, pt.supports_opacity, pt.shade_index) == (
        pj.uses_time, pj.supports_opacity, pj.shade_index)
    if kind == "run":
        want = np.asarray(pj.run()[1])
        got = pt.run(device="cpu")[1].numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        return
    state = _grid()
    want = jax.jit(lambda st: pj.shade(st))({k: jnp.asarray(v) for k, v in state.items()})
    got = pt.shade({k: torch.from_numpy(v) for k, v in state.items()})
    assert set(got) == set(want)
    for reg in want:
        w = np.broadcast_to(np.asarray(want[reg]), (N, N, 3))
        g = np.broadcast_to(got[reg].numpy(), (N, N, 3))
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=reg)


def test_input_loads_match_on_gated_shaders():
    """The bake gate's analysis on the shaders of tests/test_shader_bake.py
    that must stay runtime, and on helpers and branches."""
    sources = [
        "fn shade() { color = vec3(fract(hitpoint.y), 0.3, 0.3); }",
        "fn shade() { color = color * 0.5; }",
        "fn shade() { color.x = 1.0; }",
        "fn shade() { metallic += 0.1; }",
        "fn shade() { if (uv.x > 0.5) { color = vec3(1); } color = color*2.0; }",
        "fn t() { color = color*0.5; } fn shade() { t(); }",
        "fn shade() { match uv.x { 1 { normal = vec3(1); } _ { } } let k = normal; }",
    ]
    for src in sources:
        assert tx.Program(tx.parse(src)).input_loads == jx.Program(jx.parse(src)).input_loads, src


def test_wood_bake_state_matches_jax():
    """The bench's wood shader over the 128² bake grid: every output
    register within 1e-5 (the colour differs in the last bits on ~11% of
    its values: XLA fuses mix's `a + (b - a) * t` and the noise sums), the
    constant roughness exactly."""
    want = jx.Rusteria.bake_state(jx.Program(jx.parse(WOOD_SHADER)), 128)
    got = tx.Rusteria.bake_state(tx.Program(tx.parse(WOOD_SHADER)), 128, device="cpu")
    assert set(got) == set(want)
    for reg in want:
        assert got[reg].shape == (128, 128, 3)
        np.testing.assert_allclose(got[reg], want[reg], atol=1e-5, rtol=0, err_msg=reg)
    np.testing.assert_array_equal(got["roughness"], want["roughness"])
    assert got["roughness"].min() == got["roughness"].max() == np.float32(0.6)


SCRIPT = """
fn stripes() {
    color = vec3(fract(uv.x * 4.0), uv.y, 0.25);
}
fn rings() {
    return vec3(sin(length(uv - vec2(0.5)) * 20.0) * 0.5 + 0.5);
}
let a = alloc(16, 8);
let b = alloc(8, 8);
iterate(a, "stripes");
iterate(b, "rings");
save(a, "textures/stripes.png");
save(b, "rings.png");
"""


def test_execute_script_matches_jax():
    """alloc / iterate / save: the textures and the derived normal maps."""
    ej = jx.Rusteria.execute_script(SCRIPT)
    et = tx.Rusteria.execute_script(SCRIPT, device="cpu")
    assert sorted(et.saved) == sorted(ej.saved) == [
        "rings", "rings_normal", "stripes", "stripes_normal"]
    for k, want in ej.saved.items():
        assert et.saved[k].shape == want.shape
        np.testing.assert_allclose(et.saved[k], want, atol=1e-5, rtol=0, err_msg=k)


def test_entry_points_take_the_card_unless_asked_for_the_cpu():
    """device=None means CUDA: without a GPU the bakes raise instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    prog = tx.Program(tx.parse(WOOD_SHADER))
    for call in (lambda: tx.Rusteria.bake_state(prog, 8),
                 lambda: tx.Rusteria.shade_image(prog, 8, 8),
                 lambda: prog.run()):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
