"""``repro_torch.launch.dryrun`` and what it builds, against the JAX
package's dry run.

- Full width, all 10 architectures, on the meta device: every parameter's
  logical axes and global shape equal the reference's ``param_axes()``
  and ``param_shapes()`` (``jax.eval_shape``: nothing allocated), its
  stacked "layer" axis stripped and matched by name.
- On a stand-in (16, 16) mesh (both packages' resolution reads only axis
  names and sizes), every master weight's placements
  (``param_sharding``) equal the reference's ``DistContext.spec``, and
  each rank's working-weight slice (``tp_dims`` after ``_shard_tp`` at a
  "model" width of 16) equals the spec's "model" entry, but for the
  port's design choices, each named in ``WHOLE_WORKING``: KV heads that
  do not divide the width are whole on every rank (the reference's spec
  splits their flattened (D, Hkv hd) matrices mid-head), and so are the
  query heads of an attention whose heads do not divide it (the sequence
  fallback, or the whole attention). The RG-LRU's weights carry "lru",
  which has no rule: whole in both.
- ``input_specs`` gives the reference's input shapes and dtypes for every
  (arch x shape) pair, the decode cache through ``init_cache`` on meta;
  ``Model.cache_dims`` is the reference's for every architecture.
- One small walk (``tests/torch_dryrun_workers.py``, a subprocess with a
  fake group of 256 ranks): a reduced configuration of each family, its
  train, prefill and decode cells on (16, 16) as rank 37. Each runs, its
  JSON has every key ``run_cell`` writes, and each per-rank cache shape
  equals the reference's ``cache_dims`` spec of its global shape, but for
  the layouts the port keeps on purpose (``WHOLE_CACHE``). A served
  cell (prefill, decode) holds as its weights exactly the sum of its
  shards under the reference's ``param_sharding`` resolution, in
  bfloat16, and its collectives count at least the "data" all-gather of
  every weight's "model" slice. The moe train cell at ``reduced``'s 4
  experts, which "model" = 16 does not split, runs: the ZeRO-3 step
  routes the batch across the 16 batch ranks that share its "model"
  coordinate.
"""
import functools
import math
import types

import jax
import pytest

import torch_dryrun_workers as workers
from repro.configs import applicable_shapes as jax_applicable_shapes
from repro.configs import get_config as jax_get_config
from repro.configs import get_shape as jax_get_shape
from repro.configs import reduced as jax_reduced
from repro.dist import api as jax_dist
from repro.models import common as jax_common
from repro.models.model import Model as JaxModel
from repro.models.model import input_specs as jax_input_specs
import repro_torch.configs
from repro_torch.configs import get_config, get_shape, list_configs
from repro_torch.dist import api as dist
from repro_torch.launch import dryrun
from repro_torch.launch.roofline import Roofline
from repro_torch.models.model import Model, input_specs

ARCHS = [a.replace("_", "-") for a in list_configs()]
STACKS = ("layers", "units", "enc_layers", "dec_layers")
MESH = dict(data=16, model=16)


def fake_mesh(**shape):
    """What both packages' resolution reads of a mesh: its axis names and
    their sizes."""
    return types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))


def _flat(tree, prefix="", stacks=STACKS):
    """{dotted name: leaf} of a nested dict; a subtree of ``stacks`` (a
    parameter tree's stacked layers) has its leaves under "<stack>.*." (one
    name for all its layers), the hybrid tail's under "tail.<i>."."""
    out = {}
    for key, val in tree.items():
        if key == "tail":
            for i, lp in (val.items() if isinstance(val, dict)
                          else enumerate(val)):
                out.update(_flat(lp, f"{prefix}tail.{i}.", stacks))
        elif isinstance(val, dict):
            sub = f"{prefix}{key}.*." if key in stacks else f"{prefix}{key}."
            out.update(_flat(val, sub, stacks))
        else:
            out[f"{prefix}{key}"] = val
    return out


def _ref_key(name: str) -> str:
    parts = name.split(".")
    if parts[0] in STACKS:
        parts[1] = "*"
    return ".".join(parts)


@functools.lru_cache(maxsize=None)
def reference(arch):
    """{port parameter name: (axes, global shape)} of the reference's
    full-width model, its "layer" axis stripped: the trees its
    ``param_axes()`` and ``param_shapes()`` read, from one
    ``jax.eval_shape`` of its ``init``."""
    jm = JaxModel(jax_get_config(arch))
    shapes, axes = jax_common.split(jax.eval_shape(jm.init,
                                                   jax.random.key(0)))
    axes, shapes = _flat(axes), _flat(shapes)
    out = {}
    for key, ax in axes.items():
        shape = tuple(shapes[key].shape)
        if ".*." in key:
            assert ax[0] == "layer", (key, ax)
            ax, shape = ax[1:], shape[1:]
        out[key] = (tuple(ax), shape)
    return out


@functools.lru_cache(maxsize=None)
def port(arch):
    return Model(get_config(arch), device="meta", seed=None)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_axes_and_shapes_match_reference(arch):
    ref, model = reference(arch), port(arch)
    got = {name: (tuple(ax), tuple(model.global_shapes()[name]))
           for name, ax in model.param_axes().items()}
    assert {_ref_key(n) for n in got} == set(ref)
    for name, val in got.items():
        assert val == ref[_ref_key(name)], name
    assert all(p.device.type == "meta" for p in model.parameters())


def _spec_of(placements, ctx):
    """The reference's spec entries of DTensor placements (one per mesh
    axis, in the mesh's order)."""
    dims = {}
    for axis, pl in zip(ctx.sizes, placements):
        if isinstance(pl, dist.Shard):
            dims.setdefault(pl.dim, []).append(axis)
    return dims


@pytest.mark.parametrize("arch", ARCHS)
def test_master_placements_match_reference_spec(arch):
    model = port(arch)
    ctx = dist.DistContext(fake_mesh(**MESH))
    jctx = jax_dist.DistContext(fake_mesh(**MESH))
    placed = dist.param_sharding(model.param_axes(), model.global_shapes(),
                                 ctx)
    for name, ax in model.param_axes().items():
        spec = jctx.spec(ax, model.global_shapes()[name])
        want = {i: [e] if isinstance(e, str) else list(e)
                for i, e in enumerate(spec) if e is not None}
        assert _spec_of(placed[name], ctx) == want, name


def _kv_whole(cfg, name):
    return cfg.num_kv_heads % MESH["model"] != 0 and \
        name.split(".")[-1] in ("wk", "wv", "bk", "bv")


def _q_whole(cfg, name):
    return cfg.num_heads % MESH["model"] != 0 and \
        name.split(".")[-1] in ("wq", "wo", "bq")


# the port's design choices: parameters whose working weight is whole on
# every rank where the reference's spec splits it over "model" (the ZeRO-3
# step gathers their masters over "model", ``_Zero3.whole``)
WHOLE_WORKING = {
    "KV heads that do not divide 'model'": _kv_whole,
    "query heads that do not divide 'model' (the sequence fallback, or "
    "the whole attention)": _q_whole,
}


@pytest.mark.parametrize("arch", ARCHS)
def test_working_slices_match_the_spec_but_named_choices(arch):
    cfg = get_config(arch)
    model = Model(cfg, device="meta", seed=None)
    model._shard_tp(dist.TPGroup(None, 0, MESH["model"], False))
    jctx = jax_dist.DistContext(fake_mesh(**MESH))
    excepted = {}
    for name, ax in model.param_axes().items():
        shape = model.global_shapes()[name]
        spec = jctx.spec(ax, shape)
        split = [i for i, e in enumerate(spec)
                 if e == "model" or (isinstance(e, tuple) and "model" in e)]
        want = split[0] if split else None
        got = model.tp_dims.get(name)
        if got == want:
            if got is not None:
                assert tuple(getattr(model.get_parameter(name), "shape")) \
                    [got] * MESH["model"] == shape[got]
            continue
        why = [k for k, rule in WHOLE_WORKING.items() if rule(cfg, name)]
        assert got is None and why, (name, spec, got)
        excepted[why[0]] = excepted.get(why[0], 0) + 1
    # the choices occur where the configurations make them
    kv = cfg.family != "ssm" and cfg.num_kv_heads % 16 != 0
    q = cfg.family != "ssm" and cfg.num_heads % 16 != 0
    assert bool(excepted.get(next(iter(WHOLE_WORKING)))) == kv
    assert bool(excepted.get(list(WHOLE_WORKING)[1])) == q


PAIRS = [(arch, shape) for arch in ARCHS
         for shape in jax_applicable_shapes(jax_get_config(arch))]


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_input_specs_match_reference(arch, shape):
    got = input_specs(get_config(arch), get_shape(shape))
    want = jax_input_specs(jax_get_config(arch), jax_get_shape(shape))
    flat_got = {k: v for k, v in _flat(_lists(got), stacks=()).items()
                if hasattr(v, "shape")}
    flat_want = {k: v for k, v in _flat(_lists(want), stacks=()).items()
                 if k not in ("cache.pos",)}
    assert set(flat_got) == set(flat_want)
    for key, t in flat_got.items():
        assert t.device.type == "meta", key
        assert tuple(t.shape) == tuple(flat_want[key].shape), key
        assert str(t.dtype).split(".")[-1] == str(flat_want[key].dtype), key


def _lists(tree):
    """Tuples and lists as dicts of their positions (for ``_flat``); a
    tuple of axis names is a leaf."""
    if isinstance(tree, dict):
        return {k: _lists(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and all(a is None or isinstance(a, str)
                                       for a in tree):
        return tree
    if isinstance(tree, (tuple, list)):
        return {str(i): _lists(v) for i, v in enumerate(tree)}
    return tree


# ------------------------------------------------------------ small walk


@pytest.fixture(scope="module")
def walk(tmp_path_factory):
    return workers.run_suite("walk", tmp_path_factory.mktemp("walk"))


def test_every_family_cell_runs_and_writes_every_key(walk):
    keys = {"arch", "shape", "mesh", "chips", "kind", "rank", "rows",
            "weights_dtype", "reference_weights_dtype", "build_s", "step_s",
            "memory", "cache_shapes", "step_static", "roofline"}
    roofline_keys = set(Roofline("a", "s", "m", 1, 1.0, 1.0, 0.0, {},
                                 1.0).to_dict())
    for family in workers.WALK:
        for shape in workers.CELLS:
            got = walk[f"{family}/{shape}"]
            assert set(got) == keys, (family, shape)
            assert set(got["roofline"]) == roofline_keys
            assert got["rank"] == workers.RANK and got["mesh"] == "16x16"
            assert got["step_static"]["flops_per_chip"] > 0
            assert got["memory"]["fits"] is True
            assert got["memory"]["total"] == sum(
                v for k, v in got["memory"].items()
                if k not in ("total", "fits"))
            rows = get_shape(shape).global_batch // MESH["data"]
            assert got["rows"] == rows


def test_kernel_stand_ins_ran_in_every_family_that_has_kernels(walk):
    calls = {f: walk[f"{f}/train_4k"]["step_static"]["kernel_calls"]
             for f in workers.WALK}
    assert calls["ssm"] == {"wkv6": 4, "wkv6_bwd": 2}
    assert calls["hybrid"]["rglru"] == 4 and calls["hybrid"]["rglru_bwd"] == 2
    for family in ("dense", "moe", "vlm", "audio", "hybrid"):
        assert calls[family]["flash_attention_bwd"] > 0, family


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_dims_are_the_references(arch):
    got = port(arch).cache_dims()
    want = JaxModel(jax_get_config(arch)).cache_dims()
    assert _flat(_lists(got), stacks=()) == _flat(_lists(want), stacks=())


def _ring(path):
    return path.startswith(("units.l2_attn", "tail."))


def _cross(path):
    return path in ("layers.2", "layers.3")


# the cache layouts the port keeps on purpose (``models/model.py``'s
# docstring): the hybrid rings whole on every rank, where the reference's
# spec splits their window over "model"; the audio cross K/V on the rank's
# KV heads where "model" divides them (else whole), where the spec splits
# the encoder's frames
WHOLE_CACHE = {"hybrid": _ring, "audio": _cross}


@pytest.mark.parametrize("family", sorted(workers.WALK))
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_cache_shapes_follow_the_references_cache_dims(walk, family, shape):
    arch = workers.WALK[family]
    cfg = workers.config(family, jax_get_config(arch), jax_reduced)
    shp = jax_get_shape(shape)
    model = JaxModel(cfg)
    cache = jax.eval_shape(functools.partial(
        model.init_cache, shp.global_batch, shp.seq_len))
    dims = _flat(_lists(model.cache_dims()), stacks=())
    glob = {k: tuple(v.shape)
            for k, v in _flat(_lists(cache), stacks=()).items() if k != "pos"}
    jctx = jax_dist.DistContext(fake_mesh(**MESH))
    got = walk[f"{family}/{shape}"]["cache_shapes"]
    assert set(got) == set(glob)
    for path, shape_ in glob.items():
        spec = jctx.spec(dims[path], shape_)
        want = [n // math.prod(MESH[a] for a in
                               ((e,) if isinstance(e, str) else e or ()))
                for n, e in zip(shape_, spec)]
        keep = WHOLE_CACHE.get(family)
        if keep and keep(path):
            whole = [n // MESH["data"] if e and "data" in e else n
                     for n, e in zip(shape_, spec)]
            assert got[path] == whole, path
            continue
        assert got[path] == want, path


def test_moe_with_experts_model_does_not_split_raises(walk):
    """No longer raises: the moe train cell whose 4 experts "model" = 16
    does not split runs on rank 37, its step routing the batch across the
    16 batch ranks (one all-gather of the expert counts a layer)."""
    got = walk["pinned"]
    assert got["kind"] == "train" and got["rank"] == workers.RANK
    assert got["rows"] == get_shape("train_4k").global_batch // MESH["data"]
    assert got["step_static"]["flops_per_chip"] > 0
    assert got["memory"]["fits"] is True
    assert got["step_static"]["kernel_calls"]["flash_attention_bwd"] > 0


def _entry(e) -> tuple:
    return (e,) if isinstance(e, str) else e or ()


def _shard_bytes(cfg, itemsize: int) -> tuple:
    """(bytes of every parameter's block under the reference's
    ``param_sharding`` resolution on (16, 16), bytes of the "model" slices
    of the parameters it splits over "data", bytes of a rank's working
    weights, every one whole over "data")."""
    model = Model(cfg, device="meta", seed=None)
    jctx = jax_dist.DistContext(fake_mesh(**MESH))
    shards = gathered = 0
    for name, axes in model.param_axes().items():
        shape = model.global_shapes()[name]
        spec = [_entry(e) for e in jctx.spec(axes, shape)]
        shards += math.prod(n // math.prod(MESH[a] for a in e)
                            for n, e in zip(shape, spec))
        if any("data" in e for e in spec):
            gathered += math.prod(n // (MESH["model"] if "model" in e
                                        else 1) for n, e in zip(shape, spec))
    model._shard_tp(dist.TPGroup(None, 0, MESH["model"], False))
    working = sum(p.numel() for p in model.parameters())
    return shards * itemsize, gathered * itemsize, working * itemsize


@pytest.mark.parametrize("family", sorted(workers.WALK))
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_served_cells_hold_their_fsdp_shards(walk, family, shape):
    """A served cell's weights a rank are its shards under the reference's
    ``param_sharding`` (bfloat16), less than its working weights are
    gathered at once, and its all-gathers count at least every "data"
    split weight's "model" slice, gathered once a call."""
    got = walk[f"{family}/{shape}"]
    cfg = workers.config(family, get_config(workers.WALK[family]),
                         repro_torch.configs.reduced)
    shards, gathered, working = _shard_bytes(cfg, 2)
    assert got["weights_dtype"] == "bfloat16"
    assert got["reference_weights_dtype"] == "float32"
    assert got["memory"]["weights"] == shards
    assert 0 < got["memory"]["gathered"] < working
    assert got["roofline"]["coll_breakdown"]["all-gather"] >= gathered


def test_cell_needs_a_process_of_its_own(monkeypatch):
    monkeypatch.setattr(dryrun.tdist, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="process of its own"):
        dryrun.init_fake_group(256, 0)
