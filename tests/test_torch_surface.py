"""Surface parity: the port has every public name of the JAX package.

Both packages are read as source with ``ast`` (nothing is imported, so
no ``jax``).  For every module of ``lightgbm_tpu/`` the port's module at
the same path must define every public top-level function, class and
constant, every public method of each class (inherited from a class of
the same module counts), and every parameter name of those functions
and methods.  An ``__init__.py`` must also bind every name the JAX one
re-exports (its relative imports and ``__all__``).  Private names
(a leading ``_``, dunder methods apart) are not checked.

What the port rightly lacks is in one table, ``JAX_ONLY``, each entry
with its reason: XLA-, Pallas- and jit-only machinery, and names the
port keeps under another name (the entry says which, and the test
checks that the port has it).  An entry that names nothing the port
lacks fails the test, so the table cannot go stale.
"""

import ast
import os
from typing import Dict, NamedTuple, Optional

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "lightgbm_tpu")
PORT_PKG = os.path.join(ROOT, "lightgbm_tpu_torch")


class Only(NamedTuple):
    reason: str
    renamed: Optional[str] = None   # the port's name for the same thing


_JIT = "jax.jit instrumentation; the port's compile ledger records nvcc builds"
_MESH = ("the jax mesh and its axis; the port's collectives run over a "
         "torch.distributed group")
_REGISTRY = "the shared jit-program registry; the port keeps no jitted programs"

# (module, None) a whole module; (module, name) a top-level name or
# "Class.method" ("*.method": every class of the module); (module, name,
# param) one parameter of a function or method.
JAX_ONLY: Dict[tuple, Only] = {
    ("ops/pallas_histogram.py", None): Only(
        "Pallas TPU kernels: K2 and K3 are csrc/children_hist.cu behind "
        "ops/children_hist.py"),
    ("ops/pallas_walk.py", None): Only(
        "Pallas TPU kernel: K4 is csrc/forest_walk.cu behind "
        "ops/forest_walk.py"),
    ("parallel/_compat.py", None): Only("a jax version shim"),
    ("utils/compile_cache.py", None): Only(
        "XLA's persistent compile cache: the port keeps its nvcc builds by "
        "hash in build/ (ops/_build.py)"),
    ("obs/compile_ledger.py", "InstrumentedJit"): Only(_JIT),
    ("obs/compile_ledger.py", "instrumented_jit"): Only(_JIT),
    ("obs/compile_ledger.py", "abstract_shapes"): Only(_JIT),
    ("obs/__init__.py", "InstrumentedJit"): Only(_JIT),
    ("obs/__init__.py", "instrumented_jit"): Only(_JIT),
    ("obs/__init__.py", "abstract_shapes"): Only(_JIT),
    ("obs/devprof.py", "timed_dispatch", "dispatch"): Only(
        "the callable; the port's module has a dispatch() scope, so the "
        "parameter is fn", renamed="fn"),
    ("obs/devprof.py", "timed_dispatch", "cache_size"): Only(
        "a jitted program's cache size, read to skip compiling calls"),
    ("serve/batcher.py", "CountingJit"): Only(
        "counts jax.jit traces; the port counts K4 launches "
        "(ops/forest_walk.launch_counts)"),
    ("serve/forest.py", "CompiledForest.walk_vmem_bytes"): Only(
        "TPU VMEM sizing of the Pallas walk; the port plans shared memory "
        "in ops/forest_walk.plan_walk"),
    ("ops/leafhist.py", "digit_histogram_pallas"): Only(
        "the Pallas kernel: K1 is csrc/leaf_hist.cu behind "
        "leafhist.digit_histogram"),
    ("ops/leafhist.py", "digit_histogram_scatter"): Only(
        "K1's plain version", renamed="digit_histogram_plain"),
    ("ops/histogram.py", "children_split_candidates", "bundle"): Only(
        "EFB columns: the port's grower expands K2's bundled histograms "
        "itself (ops/grow.py SerialComm) and sends K3 only unbundled ones"),
    ("ops/ordered_grow.py", "grow_tree_ordered", "bins"): Only(
        "feature-major bins: the port's ordered grower reads only the "
        "row-major ones", renamed="bins_rm"),
    ("ops/ordered_grow.py", "grow_tree_ordered", "bins_words"): Only(
        "the Pallas kernel's packed u8 words; K1 reads bins_rm"),
    ("models/linear.py", "pack_linear"): Only(
        "packs the linear arrays into the jitted round's one device_get; "
        "the port reads them directly"),
    ("models/linear.py", "unpack_linear"): Only(
        "the host inverse of pack_linear"),
    ("models/gbdt.py", "estimate_train_memory", "num_features"): Only(
        "the histogram's width, which the port counts in EFB columns",
        renamed="num_columns"),
    ("models/gbdt.py", "estimate_train_memory", "donate_score"): Only(
        "XLA buffer donation of the score"),
    ("objective/__init__.py", "*.program_key"): Only(_REGISTRY),
    ("objective/__init__.py", "*.program_holder"): Only(_REGISTRY),
    ("objective/__init__.py", "*.uses_legacy_gradients"): Only(
        "routes closure-state subclasses around the jit registry"),
    ("objective/__init__.py", "*.gradient_arrays", "num_rows"): Only(
        "padding to the jit row bucket; the port's arrays take the "
        "device", renamed="device"),
    ("parallel/grow.py", "make_comm", "axis_name"): Only(_MESH),
    ("parallel/grow.py", "make_parallel_grow", "mesh"): Only(_MESH),
    ("parallel/grow.py", "make_parallel_grow", "axis_name"): Only(_MESH),
    ("parallel/ingest.py", "binned_dataset_from_shards", "mesh"): Only(
        _MESH),
    ("parallel/ingest.py", "binned_dataset_from_shards", "axis"): Only(
        _MESH),
    ("parallel/ingest.py", "binned_dataset_from_shards", "shards"): Only(
        "the mesh's device shards; a rank holds its own rows"),
    ("parallel/ingest.py", "distributed_find_bin", "mesh"): Only(_MESH),
    ("parallel/ingest.py", "distributed_find_bin", "axis"): Only(_MESH),
    ("parallel/ingest.py", "distributed_find_bin", "shards"): Only(
        "the mesh's device shards; a rank holds its own rows"),
    ("parallel/ingest.py", "make_psum"): Only(_MESH),
    ("parallel/ingest.py", "shard_bins_to_devices"): Only(_MESH),
    ("parallel/multihost.py", "globalize_grow_fn"): Only(
        "wraps a jitted grower for a multi-host jax mesh"),
    ("parallel/multihost.py", "initialize_with_retry",
     "coordinator_address"): Only(
        "jax.distributed's coordinator; torch.distributed's init method",
        renamed="init_method"),
    ("parallel/multihost.py", "initialize_with_retry", "num_processes"):
        Only("torch.distributed's name", renamed="world_size"),
    ("parallel/multihost.py", "initialize_with_retry", "process_id"): Only(
        "torch.distributed's name", renamed="rank"),
    ("capi/impl.py", "ffi"): Only(
        "cffi embedding; the port hands ctypes callbacks to its C shim"),
    ("capi/impl.py", "bind"): Only(
        "installs the cffi externs; the port hands its callbacks to the "
        "shim's LGBM_TorchBind", renamed="bind_library"),
    ("capi/impl.py", "LGBM_GetLastError"): Only(
        "answered in C from a thread-local buffer (capi/c_api.c), never "
        "in Python"),
}


class Module(NamedTuple):
    names: Dict[str, str]            # public name -> function/class/value
    params: Dict[str, list]          # function or "Class.method" -> names
    methods: Dict[str, Dict[str, list]]   # class -> method -> params


def _params(fn) -> list:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")]


def _public(name: str) -> bool:
    return not name.startswith("_") or (name.startswith("__")
                                        and name.endswith("__"))


def _top_level(body):
    """Statements at module level, inside top-level if/try too."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _top_level(node.body + node.orelse)
        elif isinstance(node, ast.Try):
            yield from _top_level(node.body + node.orelse + node.finalbody)
            for h in node.handlers:
                yield from _top_level(h.body)
        else:
            yield node


def read_module(path: str) -> Module:
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    init = os.path.basename(path) == "__init__.py"
    names: Dict[str, str] = {}
    params: Dict[str, list] = {}
    classes: Dict[str, tuple] = {}
    for node in _top_level(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names[node.name] = "function"
            params[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            names[node.name] = "class"
            own = {b.name: _params(b) for b in node.body
                   if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))}
            bases = [b.id for b in node.bases if isinstance(b, ast.Name)]
            classes[node.name] = (own, bases)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name):
                    names[t.id] = "value"
                    if t.id == "__all__" and isinstance(node.value,
                                                        (ast.List, ast.Tuple)):
                        for elt in node.value.elts:
                            if isinstance(elt, ast.Constant):
                                names.setdefault(elt.value, "exported")
        elif isinstance(node, ast.ImportFrom) and init and node.level:
            # an __init__'s relative imports are its re-exports
            for al in node.names:
                names[al.asname or al.name] = "reexport"
    methods: Dict[str, Dict[str, list]] = {}

    def resolve(cls, seen=()):
        own, bases = classes[cls]
        out: Dict[str, list] = {}
        for b in bases:
            if b in classes and b not in seen:
                out.update(resolve(b, seen + (cls,)))
        out.update(own)
        return out

    for cls in classes:
        methods[cls] = resolve(cls)
        for m, ps in methods[cls].items():
            params[f"{cls}.{m}"] = ps
    return Module(names, params, methods)


def _modules(pkg: str):
    out = []
    for root, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(root, f), pkg))
    return sorted(out)


@pytest.fixture(scope="module")
def packages():
    jax = {rel: read_module(os.path.join(JAX_PKG, rel))
           for rel in _modules(JAX_PKG)}
    port = {rel: read_module(os.path.join(PORT_PKG, rel))
            for rel in _modules(PORT_PKG)}
    return jax, port


def _entry(mod: str, name: str, param: str = None) -> Optional[Only]:
    """The table entry covering (mod, name[, param]), wildcards included."""
    if (mod, None) in JAX_ONLY:
        return JAX_ONLY[(mod, None)]
    keys = [(mod, name) if param is None else (mod, name, param)]
    if "." in name:
        keys.append(keys[0][:1] + ("*." + name.split(".", 1)[1],)
                    + keys[0][2:])
    for k in keys:
        if k in JAX_ONLY:
            return JAX_ONLY[k]
    return None


def surface_gaps(jax: Dict[str, Module], port: Dict[str, Module]):
    """Every (module, name[, param]) of the JAX package the port lacks and
    the table does not cover, and every renamed entry whose port name is
    missing."""
    gaps = []
    for rel, jm in jax.items():
        pm = port.get(rel)
        if pm is None:
            if _entry(rel, None) is None:
                gaps.append((rel, "<module>"))
            continue
        wanted = [n for n in jm.names if _public(n)]
        for cls, meths in jm.methods.items():
            # a class the port lacks is one gap (or one entry), not one a
            # method
            if _public(cls) and cls in pm.methods:
                wanted += [f"{cls}.{m}" for m in meths if _public(m)]
        for name in wanted:
            if "." in name:
                cls, meth = name.split(".", 1)
                have = meth in pm.methods.get(cls, {})
            else:
                have = name in pm.names
            entry = _entry(rel, name)
            if not have:
                if entry is None:
                    gaps.append((rel, name))
                elif entry.renamed and entry.renamed not in pm.names:
                    gaps.append((rel, name, "renamed to missing "
                                 + entry.renamed))
                continue
            if name not in jm.params or name not in pm.params:
                continue
            for p in jm.params[name]:
                if p in pm.params[name]:
                    continue
                entry = _entry(rel, name, p)
                if entry is None:
                    gaps.append((rel, name, p))
                elif entry.renamed and entry.renamed not in pm.params[name]:
                    gaps.append((rel, name, p, "renamed to missing "
                                 + entry.renamed))
    return gaps


def stale_entries(jax: Dict[str, Module], port: Dict[str, Module]):
    """Table entries that name nothing the JAX package has and the port
    lacks."""
    stale = []
    for key in JAX_ONLY:
        mod, name = key[0], key[1]
        jm, pm = jax.get(mod), port.get(mod)
        if jm is None:
            stale.append(key)
            continue
        if name is None:
            if pm is not None:
                stale.append(key)
            continue
        if name.startswith("*."):
            meth = name[2:]
            pairs = [(f"{c}.{meth}", meth in pm.methods.get(c, {})
                      if pm else False)
                     for c, ms in jm.methods.items() if meth in ms]
        else:
            pairs = [(name, name in jm.params or name in jm.names)]
        live = False
        for qual, _ in pairs:
            if "." in qual:
                cls, meth = qual.split(".", 1)
                in_jax = meth in jm.methods.get(cls, {})
                in_port = pm is not None and meth in pm.methods.get(cls, {})
            else:
                in_jax = qual in jm.names
                in_port = pm is not None and qual in pm.names
            if not in_jax:
                continue
            if len(key) == 2:
                live |= not in_port
            else:
                param = key[2]
                live |= (param in jm.params.get(qual, [])
                         and in_port
                         and param not in pm.params.get(qual, []))
        if not live:
            stale.append(key)
    return stale


def test_port_has_every_public_name_of_the_jax_package(packages):
    jax, port = packages
    assert len(jax) > 50 and len(port) > 50
    assert surface_gaps(jax, port) == []


def test_every_jax_only_entry_has_a_reason_and_is_live(packages):
    jax, port = packages
    for key, entry in JAX_ONLY.items():
        assert entry.reason.strip(), key
    assert stale_entries(jax, port) == []


@pytest.mark.parametrize("mod,name", [
    ("serve/fleet.py", "Fleet.warm_all"),
    ("models/gbdt.py", "GBDT.train"),
    ("ops/predict.py", "predict_leaf_indices_forest"),
    ("utils/log.py", "enable_stdlib_bridge"),
    ("config.py", "default_metric_for_objective"),
    ("__init__.py", "Config"),
])
def test_a_name_taken_out_of_the_port_is_a_gap(packages, mod, name):
    jax, port = packages
    pm = port[mod]
    if "." in name:
        cls, meth = name.split(".", 1)
        meths = {k: v for k, v in pm.methods[cls].items() if k != meth}
        cut = pm._replace(methods={**pm.methods, cls: meths})
    else:
        cut = pm._replace(names={k: v for k, v in pm.names.items()
                                 if k != name})
    assert (mod, name) in surface_gaps(jax, {**port, mod: cut})


@pytest.mark.parametrize("mod,name,param", [
    ("serve/server.py", "PredictServer.__init__", "warm_in_background"),
    ("models/__init__.py", "create_boosting", "objective"),
    ("basic.py", "Booster.compile", "warmup"),
])
def test_a_parameter_taken_out_of_the_port_is_a_gap(packages, mod, name,
                                                   param):
    jax, port = packages
    pm = port[mod]
    params = {**pm.params, name: [p for p in pm.params[name] if p != param]}
    assert (mod, name, param) in surface_gaps(
        jax, {**port, mod: pm._replace(params=params)})


def test_an_entry_for_a_name_the_port_has_is_stale(packages, monkeypatch):
    jax, port = packages
    monkeypatch.setitem(JAX_ONLY, ("serve/fleet.py", "Fleet.warm_all"),
                        Only("not a gap"))
    monkeypatch.setitem(JAX_ONLY, ("basic.py", "Booster.compile", "warmup"),
                        Only("not a gap"))
    stale = stale_entries(jax, port)
    assert ("serve/fleet.py", "Fleet.warm_all") in stale
    assert ("basic.py", "Booster.compile", "warmup") in stale
