"""The port's public names against the JAX package's, read from the source
with `ast` (no JAX import):

1. every name that a JAX subpackage's ``__init__.py`` re-exports imports
   from the port's subpackage of the same name;
2. every ``from henjou_tpu... import`` of JAX's tests/test_math.py,
   tests/test_cmj.py and tests/test_wavefront.py imports with
   ``henjou_torch`` in its place;
3. each JAX module's public top-level functions, classes, methods and
   upper-case constants exist in the port module of the same path, unless
   NOT_PORTED names them with the reason. A name that the JAX package
   gains, or that the port drops, fails here.
"""

import ast
import importlib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "henjou_tpu")
PORT_PKG = os.path.join(ROOT, "henjou_torch")
SUBPACKAGES = ("math", "bsdf", "integrator", "sampling", "scene", "post", "runtime", "accel",
               "texture", "utils")
JAX_TESTS = ("test_math.py", "test_cmj.py", "test_wavefront.py")

_LBVH = ("the LBVH path serves only the JAX package's CPU fallback; the port's is each "
         "kernel's plain version")
_TILE = "a TPU ray tile of the Pallas kernel; the CUDA kernels walk one ray per warp"
# {JAX module (path under henjou_tpu/): {public name, or "*" for the whole
# module: why the port does not have it}}
NOT_PORTED = {
    "accel/bitonic.py": {"LANES": "the TPU's 128-lane vreg width of the Pallas sort's layout"},
    "accel/cluster.py": {"*": _LBVH},
    "accel/lbvh.py": {"LBVH": _LBVH, "build_lbvh": _LBVH},
    "accel/pairs.py": {"*": "an XLA-only pair-list intersector that no renderer routes"},
    "accel/traverse.py": {"*": _LBVH},
    "accel/pallas_binned.py": {
        "RAY_TILE": _TILE,
        "VMEM_ROWS_BUDGET": "the TPU VMEM budget for resident cluster rows",
        "probe_ray_tile": "a probe of the TPU ray tile that compiles on the chip",
    },
    "accel/pallas_cluster.py": {"PackedClusters.vmem_bytes": "the pack's TPU VMEM footprint"},
    "accel/pallas_cluster_hbm.py": {"RAY_TILE": _TILE},
    "accel/pallas_mxu.py": {"RAY_TILE": _TILE},
    "accel/sorting.py": {
        "NUM_SUPER_THRESHOLD": "gates the TPU kernel's per-tile supercluster skip; the port "
                               "sorts every binned trace and culls per ray"},
    "math/vec.py": {"jax_rsqrt": "an XLA rsqrt lowering helper; torch.rsqrt needs none"},
    "runtime/camera.py": {"divmod_u24": "a TPU workaround for 32-bit integer division"},
    "runtime/renderer.py": {
        "DEFAULT_TILE": "the JAX masked engine's jitted step size; the port's is MASKED_TILE"},
    "runtime/sharding.py": {
        "make_mesh": "the port runs one process per GPU in a torch.distributed group, no mesh"},
    "sampling/cmj.py": {
        "set_sobol_enabled": "the port chooses Sobol per renderer on its CMJ states",
        "sobol_enabled": "the port chooses Sobol per renderer on its CMJ states",
    },
    "sampling/light_sample.py": {
        "LIGHT_SAMPLING": "the port reads HENJOU_LIGHT_SAMPLING when it builds a light table"},
}


def _public_names(path):
    """Public top-level functions, classes (and their public methods, as
    Class.method) and upper-case constants of a module's source."""
    out = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            out.update(f"{node.name}.{m.name}" for m in node.body
                       if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out.update(n.id for t in targets for n in ast.walk(t)
                       if isinstance(n, ast.Name) and n.id.isupper())
    return {n for n in out if not any(part.startswith("_") for part in n.split("."))}


def _imports_from(path, package="henjou_tpu"):
    """[(module, [names])] of a source's ``from <package>... import``."""
    return [(node.module, [a.name for a in node.names])
            for node in ast.walk(ast.parse(open(path).read()))
            if isinstance(node, ast.ImportFrom) and node.module
            and node.module.split(".")[0] == package]


def _jax_modules():
    out = []
    for base, _, files in os.walk(JAX_PKG):
        out += [os.path.relpath(os.path.join(base, f), JAX_PKG) for f in files if f.endswith(".py")]
    return sorted(out)


def _assert_importable(module, names):
    mod = importlib.import_module(module)
    missing = [n for n in names if not hasattr(mod, n)]
    assert not missing, f"{module} lacks {missing}"


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_reexports_the_jax_names(sub):
    imports = _imports_from(os.path.join(JAX_PKG, sub, "__init__.py"))
    assert imports, sub
    _assert_importable(f"henjou_torch.{sub}", [n for _, ns in imports for n in ns])
    # the same names in the same order, each from the port module of the
    # JAX module's path
    port = _imports_from(os.path.join(PORT_PKG, sub, "__init__.py"), "henjou_torch")
    assert [(m.replace("henjou_torch", "henjou_tpu", 1), ns) for m, ns in port] == imports


@pytest.mark.parametrize("test_file", JAX_TESTS)
def test_jax_test_imports_resolve_on_the_port(test_file):
    imports = _imports_from(os.path.join(ROOT, "tests", test_file))
    assert imports, test_file
    for module, names in imports:
        _assert_importable(module.replace("henjou_tpu", "henjou_torch", 1), names)


@pytest.mark.parametrize("module", _jax_modules())
def test_public_names_have_a_counterpart(module):
    skip = NOT_PORTED.get(module, {})
    want = _public_names(os.path.join(JAX_PKG, module))
    port_path = os.path.join(PORT_PKG, module)
    if "*" in skip:
        assert not os.path.exists(port_path), f"{module} is ported now: drop it from NOT_PORTED"
        return
    have = _public_names(port_path)
    missing = sorted(want - have - set(skip))
    assert not missing, f"henjou_torch/{module} lacks {missing}"
    # every exception still names a JAX name that the port lacks
    stale = sorted(n for n in skip if n not in want or n in have)
    assert not stale, f"NOT_PORTED[{module!r}] lists {stale}, which no longer apply"


def test_not_ported_entries_carry_a_reason():
    modules = set(_jax_modules())
    for module, names in NOT_PORTED.items():
        assert module in modules, module
        for name, reason in names.items():
            assert isinstance(reason, str) and len(reason.split()) >= 4, (module, name)
