"""``repro_torch.sharding`` against ``repro.sharding``: the path rules, the
param and cache spec trees of every registry config, ``logical_spec`` under
every rule table, and the local shard shapes of llama3-8b's params and
``decode_32k`` cache on fake (16, 16) and (2, 16, 16) worlds against
``NamedSharding(AbstractMesh(...), spec).shard_shape``.  The JAX side is
``eval_shape``, ``AbstractMesh`` and pure Python: nothing is compiled."""
import math

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding as JNamedSharding, PartitionSpec as P

import repro.sharding as jsh
from repro.configs import get_config as j_full, get_smoke_config as j_smoke
from repro.models.model import init_cache as j_init_cache, init_params as j_init_params
from repro.sharding.specs import _spec_for_path as j_spec_for_path
from repro_torch.configs import ARCH_IDS, get_config, get_shape, get_smoke_config
from repro_torch.launch.dryrun import RULESETS, input_specs
from repro_torch.launch.mesh import fake_world, make_production_mesh, make_test_mesh
from repro_torch.models.model import init_cache
from repro_torch.runtime.steps import abstract_state
from repro_torch.sharding import (
    DEFAULT_RULES, FSDP_SP_RULES, SEQ_PARALLEL_RULES, build_cache_specs, build_param_specs,
    constrain, logical_spec,
)
from repro_torch.sharding.specs import _spec_for_path


@pytest.fixture(autouse=True)
def _no_process_group_left():
    """pytest-xdist's ``--dist loadfile`` reuses workers: leave no group up."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


SPEC_CASES = [
    (("layers/attn/wq", 3, True), {}),
    (("layers/attn/wo", 3, True), {}),
    (("emb", 2, False), {}),
    (("lm_head", 2, False), {}),
    (("layers/moe/experts_wg", 4, True), {}),
    (("layers/ln1", 2, True), {}),
    (("layers/attn/wk", 3, True), {"replicate_kv": True}),
    (("layers/attn/wk", 3, True), {"replicate_kv": False}),
    (("layers/moe/experts_wd", 4, True), {"ep_experts": False}),
    (("blocks/sub1/mamba/A_log", 3, True), {}),
    (("pairs/slstm/slstm_r", 5, True), {}),
]


@pytest.mark.parametrize("args,kw", SPEC_CASES)
def test_spec_for_path_matches_reference(args, kw):
    assert _spec_for_path(*args, **kw) == j_spec_for_path(*args, **kw)


def test_spec_for_path_reference_cases():
    """``tests/test_sharding.py``'s cases, on the port."""
    assert _spec_for_path("layers/attn/wq", 3, scanned=True) == (None, "fsdp", "tp")
    assert _spec_for_path("layers/attn/wo", 3, scanned=True) == (None, "tp", "fsdp")
    assert _spec_for_path("emb", 2, scanned=False) == ("vocab_tp", None)
    assert _spec_for_path("lm_head", 2, scanned=False) == (None, "vocab_tp")
    assert _spec_for_path("layers/moe/experts_wg", 4, scanned=True) == (None, "ep", "fsdp_e", None)
    assert _spec_for_path("layers/ln1", 2, scanned=True) == (None, None)
    assert _spec_for_path("layers/attn/wk", 3, True, replicate_kv=True) == (None, "fsdp", None)
    assert _spec_for_path("layers/attn/wk", 3, True, replicate_kv=False) == (None, "fsdp", "tp")


def _flat(tree, prefix=""):
    """path -> leaf of a nested dict (the port's trees) or of a JAX pytree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_specs_match_reference_smoke(arch):
    _check_trees(get_smoke_config(arch), j_smoke(arch))


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-moe-a2.7b"])
def test_param_specs_match_reference_full(arch):
    _check_trees(get_config(arch), j_full(arch), cache=False)


def _check_trees(cfg, jcfg, cache: bool = True):
    rkv = cfg.n_kv_heads < cfg.n_heads
    ep = cfg.moe is None or cfg.moe.n_routed % 16 == 0
    jparams = jax.eval_shape(lambda k: j_init_params(jcfg, k), jax.random.PRNGKey(0))
    params, _ = abstract_state(cfg, with_opt=False)
    got = _flat(build_param_specs(params, replicate_kv=rkv, ep_experts=ep))
    want = _flat(jsh.build_param_specs(jparams, replicate_kv=rkv, ep_experts=ep))
    assert got == want
    if not cache:
        return
    jcache = jax.eval_shape(lambda p: j_init_cache(p, jcfg, 2, 16), jparams)
    got = _flat(build_cache_specs(init_cache(params, cfg, 2, 16), replicate_kv=rkv))
    want = _flat(jsh.build_cache_specs(jcache, replicate_kv=rkv))
    assert got == want


LOGICAL_AXES = sorted(DEFAULT_RULES) + ["fsdp_e"]
MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (2, 2): ("data", "model"), (1, 1): ("data", "model")}


@pytest.mark.parametrize("rules_name", list(RULESETS))
@pytest.mark.parametrize("shape", list(MESHES))
def test_logical_spec_matches_reference(rules_name, shape):
    port_rules = RULESETS[rules_name] or DEFAULT_RULES
    ref_rules = {"baseline": jsh.DEFAULT_RULES, "sp": jsh.SEQ_PARALLEL_RULES,
                 "fsdp_sp": jsh.FSDP_SP_RULES}[rules_name]
    assert dict(port_rules) == dict(ref_rules)
    amesh = AbstractMesh(shape, MESHES[shape])
    axes_sets = [(a, None) for a in LOGICAL_AXES] + [tuple(LOGICAL_AXES), (None,), ()]
    with fake_world(math.prod(shape)):
        if len(shape) == 3:
            mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        else:
            mesh = make_test_mesh(*shape, device_type="cpu")
        for axes in axes_sets:
            # P() compares ("data",) equal to "data", as the reference's own test does
            want = jsh.logical_spec(axes, amesh, ref_rules)
            assert P(*logical_spec(axes, mesh, port_rules)) == want, axes


def _ref_shard_shape(axes, shape, amesh, rules):
    """The reference's ``specs_to_shardings(..., abstract_tree=...)`` drop
    rule (``repro/sharding/specs.py:277-283``) on an ``AbstractMesh``,
    then JAX's own ``shard_shape``."""
    size = dict(zip(amesh.axis_names, amesh.axis_sizes))
    spec = jsh.logical_spec(axes, amesh, rules)
    fixed = []
    for i, e in enumerate(spec):
        n = 1 if e is None else size[e] if isinstance(e, str) else math.prod(size[a] for a in e)
        fixed.append(None if shape[i] % n else e)
    return JNamedSharding(amesh, P(*fixed)).shard_shape(shape)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_llama3_local_shard_shapes_match_jax(multi_pod):
    """Params (with the optimizer state) of ``train_4k`` and the
    ``decode_32k`` cache, laid out on a fake world as the dry run lays
    them out, against JAX's shard shapes (incl. the divisibility drop)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg, jcfg = get_config("llama3-8b"), j_full("llama3-8b")
    shape_ = (2, 16, 16) if multi_pod else (16, 16)
    amesh = AbstractMesh(shape_, MESHES[shape_])
    jparams = jax.eval_shape(lambda k: j_init_params(jcfg, k), jax.random.PRNGKey(0))
    pspecs = _flat(jsh.build_param_specs(jparams, replicate_kv=True))
    jcache = jax.eval_shape(lambda p: j_init_cache(p, jcfg, 128, 32768), jparams)
    cspecs = _flat(jsh.build_cache_specs(jcache, replicate_kv=True))
    jp, jc = _flat(jparams), _flat(jcache)
    with fake_world(math.prod(shape_)):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        with FakeTensorMode():
            train = input_specs(cfg, get_shape("train_4k"), mesh)
            dec = input_specs(cfg, get_shape("decode_32k"), mesh)
        got_p = {k: tuple(v.to_local().shape) for k, v in _flat(train["params"]).items()}
        got_m = {k: tuple(v.to_local().shape) for k, v in _flat(train["opt_state"]["m"]).items()}
        got_c = {k: tuple(v.to_local().shape) for k, v in _flat(dec["cache"]).items()}
    want_p = {k: _ref_shard_shape(pspecs[k], jp[k].shape, amesh, jsh.DEFAULT_RULES) for k in jp}
    want_c = {k: _ref_shard_shape(cspecs[k], jc[k].shape, amesh, jsh.DEFAULT_RULES) for k in jc}
    assert got_p == want_p and got_m == want_p
    assert got_c == want_c
    # the kv heads stay whole (replicate_kv); the 8-wide kv dim is never cut on "model"
    assert got_p["layers/attn/wk"] == (32, 4096 // 16, 1024)


def test_constrain_is_a_noop_without_a_mesh():
    x = torch.ones(4, 4)
    assert constrain(x, ("act_batch", None)) is x


def test_placements_of_tuple_entries_and_shared_axes():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding.specs import NamedSharding

    with fake_world(4):
        mesh = make_test_mesh(2, 2, "cpu")
        assert NamedSharding(mesh, (("data", "model"), None)).placements == (Shard(0), Shard(0))
        # SEQ_PARALLEL_RULES puts act_seq and act_heads on "model": the first dim keeps it
        spec = logical_spec(("act_batch", "act_seq", "act_heads", None), mesh, SEQ_PARALLEL_RULES)
        assert spec == (("data",), "model", "model", None)
        assert NamedSharding(mesh, spec).placements == (Shard(0), Shard(1))
        assert NamedSharding(mesh, (None, None)).placements == (Replicate(), Replicate())
        with pytest.raises(ValueError):
            NamedSharding(mesh, (("model", "data"),)).placements
        assert logical_spec(("fsdp", "act_seq_cache"), mesh, FSDP_SP_RULES) == (
            ("data", "model"), "model")


def test_mesh_rules_are_seen_from_another_thread():
    """The autograd engine runs a CUDA backward, and a checkpoint's
    recompute, on its own thread: the active mesh and rules must be seen
    there (a context variable would not be)."""
    import threading

    from repro_torch.sharding import active_mesh, current_rules, use_mesh_rules

    seen = []
    with fake_world(4):
        mesh = make_test_mesh(2, 2, "cpu")
        with use_mesh_rules(mesh, FSDP_SP_RULES):
            t = threading.Thread(target=lambda: seen.append((active_mesh(), current_rules())))
            t.start()
            t.join()
    assert seen == [(mesh, dict(FSDP_SP_RULES))]
    assert active_mesh() is None and current_rules() == DEFAULT_RULES


def test_kernels_refuse_a_dtensor():
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels.flash_attention import flash_attention

    with fake_world(1):
        mesh = make_test_mesh(1, 1, "cpu")
        q = DTensor.from_local(torch.ones(1, 4, 2, 64), mesh, [Replicate(), Replicate()])
        with pytest.raises(TypeError, match="local tensors"):
            flash_attention(q, q, q)


def test_seq_parallel_attention_spec_reference_refuses_port_keeps_the_first_dim():
    """ROADMAP.md §3 fault 9: under ``SEQ_PARALLEL_RULES`` the attention's
    q constraint names "model" at the sequence and the heads dims; JAX's
    ``NamedSharding`` refuses that spec, so the reference's SP rules fail
    on any mesh whose model axis is wider than 1.  The port shards the
    sequence dim (the first) and keeps the heads whole there."""
    from torch.distributed.tensor import Shard

    from repro_torch.sharding.specs import NamedSharding

    axes = ("act_batch", "act_seq", "act_heads", None)
    amesh = AbstractMesh((16, 16), ("data", "model"))
    spec = jsh.logical_spec(axes, amesh, jsh.SEQ_PARALLEL_RULES)
    with pytest.raises(Exception, match="duplicate entries for `model`"):
        JNamedSharding(amesh, spec)
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        got = NamedSharding(mesh, logical_spec(axes, mesh, SEQ_PARALLEL_RULES))
        assert got.placements == (Shard(0), Shard(1))
