"""The port's public surface against the JAX package's, by parsing both packages.

Neither package is imported: ``ast`` reads every module of
``digital_signal_processsing_tpu/`` and the module of the same path in
``digital_signal_processsing_tpu_torch/``. For each module:

- every public top-level name (``__all__`` and every top-level function, class
  or assignment whose name has no leading underscore) has the same name in the
  port's module, an entry in :data:`RENAMED`, or an entry in :data:`EXEMPT`;
- every argument of a public function or method the two share (a dataclass's
  fields are its constructor's arguments) is in the port's signature, or in
  :data:`EXEMPT`;
- every option and positional argument of the command lines ``__main__.py`` and
  ``harness/sweep.py`` is in the port's.

Each table entry names something the JAX package has and the port lacks, so the
tables cannot go stale. ``EXEMPT`` holds TPU-only names and arguments and the
documented design differences, each with its reason.
"""

from __future__ import annotations

import ast
import functools
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "digital_signal_processsing_tpu"
PORT_PKG = ROOT / "digital_signal_processsing_tpu_torch"

# "module:name" in the JAX package -> the port's name for it in the module of the same path
RENAMED = {
    "ops/fir.py:blocked_causal_conv": "causal_conv",
    "ops/fir.py:blocked_interp_conv": "interp_conv",
    "ops/pallas_scan.py:windowed_averager_pallas": "windowed_averager",
    "ops/pallas_scan.py:scan_averager_pallas": "scan_averager",
    "ops/pallas_scan.py:cumsum_pallas": "cumsum",
    "ops/pallas_direct.py:direct_averager_pallas": "direct_averager",
}

_TILES = "Pallas tiles of rows x 128 lanes; the port's kernels have their own geometry"

# "module", "module:name", "module:function(arg, ...)", or "*(arg, ...)" for an argument
# of any function -> why the port has no counterpart
EXEMPT = {
    "utils/cache.py": "the XLA persistent compile cache; the port builds its kernels through "
                      "_build.py",
    "utils/layout.py:LANES": _TILES,
    "utils/layout.py:DEFAULT_TILE_ROWS": _TILES,
    "utils/layout.py:pad_flat_to_tiles": _TILES,
    "utils/layout.py:unpad_flat": _TILES,
    "ops/pallas_scan.py:LANES": _TILES,
    "ops/pallas_scan.py:MAX_TILE_ROWS": _TILES,
    "ops/pallas_scan.py:MAX_WINDOWED_TILE_ROWS": _TILES,
    "ops/pallas_scan.py:DEFAULT_WINDOWED_TILE_ROWS": _TILES,
    "ops/pallas_scan.py:MAX_PACKED_VPU_TILE_ROWS": _TILES,
    "ops/pallas_scan.py:supports_channels": "the TPU kernels' channels | 128 lane rule; the "
                                            "port's limits are its *_supported functions",
    "ops/pallas_scan.py:windowed_tail_rows": "a seed in rows of 128 lanes; the port's seed is "
                                             "window * channels samples",
    "ops/pallas_scan.py:packed_tail_rows": "a seed in rows of 128 lanes; the port's is "
                                           "packed_seed_words",
    "ops/fft_mxu.py:pick_fused3_block": "the three-factor MXU engine's VMEM block; the port's "
                                        "B9 takes its geometry from fused_geometry",
    "ops/fir.py:FOLD_ROW_LEN": "the row fold that kept the TPU conv planner's compile short",
    "*(tile_rows)": "the rows of a Pallas tile; the port's kernels pick their own geometry",
    "*(precision)": "the passes of the TPU's bf16 matrix unit; the port computes in IEEE float32",
    "*(lane_via_mxu, lane_f32, rows_via_mxu)": "Mosaic knobs choosing how a TPU kernel spells "
                                               "its lane and row passes",
    "*(collective_id)": "the TPU's remote-copy semaphore id; the port's ring keys its buffers "
                        "itself",
    "ops/fft_mxu.py:overlap_save_fused(g)": "the first factor of the three-factor MXU engine; "
                                            "the port's B9 picks its own split",
    "parallel/mesh.py:make_mesh(devices)": "per-rank SPMD: each process drives its own card",
    "parallel/mesh.py:make_time_mesh(devices)": "per-rank SPMD: each process drives its own card",
    "models/adaptive.py:AdaptiveFir(taps, opt_state, tx)":
        "AdaptiveFir is a module holding its taps and its torch.optim.Adam",
    "models/adaptive.py:lms_train_step(taps, opt_state, tx)":
        "the step takes the AdaptiveFir, which holds the taps and the optimiser",
    "models/adaptive.py:identify_system(tx)": "the optimiser is the AdaptiveFir's Adam",
    "models/adaptive.py:make_sharded_train_step(tx)": "the optimiser is the AdaptiveFir's Adam",
}

# what the port now does and no exemption may cover again
PORTED = ("chain", "variant", "dft_factored", "fft_large", "rfft_dense", "irfft_dense",
          "rfft_dense_framed", "FACTORED_MAX_N", "DENSE_RFFT_MAX_N", "levinson", "convolve2d",
          "correlate2d", "chirp", "moving_average_two_pass", "parallel")

CLIS = ("__main__.py", "harness/sweep.py")
MODULES = sorted(p.relative_to(JAX_PKG).as_posix() for p in JAX_PKG.rglob("*.py"))
_EXEMPT_KEY = re.compile(
    r"^(?:\*|(?P<module>[\w/]+\.py)(?::(?P<name>\w+))?)(?:\((?P<args>[\w, ]+)\))?$"
)


@functools.cache
def parsed(pkg: Path, module: str) -> ast.Module | None:
    path = pkg / module
    return ast.parse(path.read_text(), str(path)) if path.is_file() else None


def declared_all(tree: ast.Module) -> list[str]:
    """A literal ``__all__``; one computed at import (the facade's) reads as none."""
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets
        ):
            try:
                return list(ast.literal_eval(node.value))
            except ValueError:
                return []
    return []


def bindings(tree: ast.Module) -> dict[str, ast.AST]:
    """Every top-level name the module binds, to the statement that binds it."""
    out: dict[str, ast.AST] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in node.targets if isinstance(node, ast.Assign) else [node.target]:
                for n in ast.walk(target):
                    if isinstance(n, ast.Name):
                        out.setdefault(n.id, node)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                out.setdefault((alias.asname or alias.name).split(".")[0], node)
        elif isinstance(node, (ast.If, ast.Try)):
            for n in ast.walk(node):
                if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
                    out.setdefault(n.name, n)
    return out


def public_names(tree: ast.Module) -> set[str]:
    names = set(declared_all(tree))
    for name, node in bindings(tree).items():
        if not name.startswith("_") and not isinstance(node, (ast.Import, ast.ImportFrom)):
            names.add(name)
    return names


def definition(module: str, name: str, depth: int = 0) -> ast.AST | None:
    """The port's def or class of ``name`` in ``module``, through its relative imports."""
    tree = parsed(PORT_PKG, module)
    node = bindings(tree).get(name) if tree else None
    if isinstance(node, ast.ImportFrom) and node.level and node.module and depth < 4:
        base = Path(module).parent
        for _ in range(node.level - 1):
            base = base.parent
        target = base / (node.module.replace(".", "/") + ".py")
        alias = next(a for a in node.names if (a.asname or a.name) == name)
        return definition(target.as_posix(), alias.name, depth + 1)
    return node


def arguments(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return names + [x.arg for x in (a.vararg, a.kwarg) if x is not None]


def signatures(node: ast.AST) -> dict[str, set[str]]:
    """A function's arguments, or a class's: its constructor's (fields and
    ``__init__``) and each public method's, by qualified name."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return {"": set(arguments(node))}
    if not isinstance(node, ast.ClassDef):
        return {}
    out = {"": {s.target.id for s in node.body
                if isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name)}}
    for s in node.body:
        if isinstance(s, ast.FunctionDef):
            if s.name == "__init__":
                out[""] |= set(arguments(s))
            elif not s.name.startswith("_"):
                out["." + s.name] = set(arguments(s))
    return out


def exempt_keys() -> list[tuple[str | None, str | None, tuple[str, ...]]]:
    """(module, name, arguments) of each EXEMPT entry; module None for "*(...)"."""
    out = []
    for key in EXEMPT:
        m = _EXEMPT_KEY.match(key)
        assert m, f"malformed EXEMPT key {key!r}"
        args = tuple(a.strip() for a in m["args"].split(",")) if m["args"] else ()
        out.append((m["module"], m["name"], args))
    return out


def exempt_args(module: str, name: str) -> set[str]:
    return {a for mod, n, args in exempt_keys() if mod is None or (mod, n) == (module, name)
            for a in args}


def lost_arguments(module: str) -> list[tuple[str, str, str]]:
    """(name, method part, argument) of every argument of a shared public function,
    method or constructor in ``module`` that the port's signature lacks
    (argument "" where the port lacks the method)."""
    jax_tree = parsed(JAX_PKG, module)
    jax_defs = bindings(jax_tree)
    out = []
    for name in sorted(public_names(jax_tree)):
        ours = definition(module, RENAMED.get(f"{module}:{name}", name))
        if name not in jax_defs or ours is None:
            continue
        have = signatures(ours)
        for part, args in signatures(jax_defs[name]).items():
            if part not in have:
                out.append((name, part, ""))
                continue
            out += [(name, part, a) for a in sorted(args - have[part]) if a not in ("self", "cls")]
    return out


def cli_arguments(tree: ast.Module) -> set[str]:
    """The first string of every ``add_argument`` call: its flag or positional name."""
    return {
        node.args[0].value
        for node in ast.walk(tree)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
        and node.func.attr == "add_argument" and node.args
        and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
    }


@pytest.mark.parametrize("module", MODULES)
def test_every_public_name_has_a_counterpart(module):
    if module in EXEMPT:
        return
    port = parsed(PORT_PKG, module)
    assert port is not None, f"the port has no {module}"
    have = set(bindings(port)) | set(declared_all(port))
    missing = []
    for name in sorted(public_names(parsed(JAX_PKG, module))):
        want = RENAMED.get(f"{module}:{name}", name)
        if want not in have and f"{module}:{name}" not in EXEMPT:
            missing.append(name if want == name else f"{name} (as {want})")
    assert not missing, f"{module}: the port lacks {missing}"


@pytest.mark.parametrize("module", MODULES)
def test_every_argument_has_a_counterpart(module):
    if module in EXEMPT:
        return
    missing = [f"{name}{part}({arg})" for name, part, arg in lost_arguments(module)
               if not arg or arg not in exempt_args(module, name)]
    assert not missing, f"{module}: the port's signatures lack {missing}"


@pytest.mark.parametrize("cli", CLIS)
def test_every_cli_argument_has_a_counterpart(cli):
    want = cli_arguments(parsed(JAX_PKG, cli))
    got = cli_arguments(parsed(PORT_PKG, cli))
    assert want and not want - got, f"{cli}: the port's command line lacks {sorted(want - got)}"


def test_renamed_entries_exist_in_both_packages():
    for key, new in RENAMED.items():
        module, name = key.split(":")
        assert name in public_names(parsed(JAX_PKG, module)), f"RENAMED {key}: not in JAX's"
        assert new in bindings(parsed(PORT_PKG, module)), f"RENAMED {key}: the port has no {new}"
        assert name not in bindings(parsed(PORT_PKG, module)), f"RENAMED {key}: the port has {name}"


def test_exempt_entries_exist_in_the_jax_package_only():
    assert all(len(reason) > 20 for reason in EXEMPT.values()), "every EXEMPT entry needs a reason"
    lost = {(m, name, arg) for m in MODULES if m not in EXEMPT
            for name, _, arg in lost_arguments(m)}
    for module, name, args in exempt_keys():
        if module is None:  # an argument of any function: some shared function uses it
            for arg in args:
                assert any(a == arg for _, _, a in lost), f"EXEMPT *({arg}): no function lacks it"
            continue
        jax_tree, port_tree = parsed(JAX_PKG, module), parsed(PORT_PKG, module)
        assert jax_tree is not None, f"EXEMPT {module}: the JAX package has no such module"
        if name is None:
            assert port_tree is None, f"EXEMPT {module}: the port has the module now"
            continue
        assert name in public_names(jax_tree), f"EXEMPT {module}:{name}: not in the JAX package"
        ours = port_tree and definition(module, RENAMED.get(f"{module}:{name}", name))
        if not args:
            assert ours is None, f"EXEMPT {module}:{name}: the port has it now"
            continue
        for arg in args:
            assert (module, name, arg) in lost, f"EXEMPT {module}:{name}({arg}): no argument " \
                "there that the port lacks"


def test_no_exemption_covers_what_the_port_now_does():
    for key in EXEMPT:
        words = set(re.findall(r"\w+", key.split(".py", 1)[-1]))
        assert not words & set(PORTED), f"EXEMPT {key} covers {sorted(words & set(PORTED))}"
