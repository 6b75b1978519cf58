"""The port's partition rules (``repro_torch.launch.shard``) against the
reference's (``repro.launch.shard``), and its mesh builder
(``repro_torch.launch.mesh``).

The reference's params of each of the ten configs at full size come from
``jax.eval_shape`` (nothing is allocated); the port's tree is the same
leaves as ``meta`` tensors, a list of per-layer dicts where the
reference stacks layers.  A port spec is the reference's with the
stacked-layer entry removed: index 0 of a per-layer param or precond
leaf, index 1 of a per-layer memory leaf (after the worker axis)."""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import shard as jshard  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402

from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import shard as tshard  # noqa: E402
from repro_torch.tree import get, leaf_paths, num_layers  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402, F401

FSDP = [(("pod", "data"), 32), (("data",), 16)]


def _archs():
    from repro_torch.configs import list_configs
    return list_configs()


def _shapes(arch):
    cfg = jconfigs.get_config(arch)
    return jax.eval_shape(lambda k: jinit(cfg, k), jax.random.PRNGKey(0))


def _meta_tree(node, layer_axis=False):
    """The reference's shape tree as the port's: meta tensors, per-layer
    leaves without the stacked axis, "layers" a list."""
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if k == "layers":
                L = jax.tree.leaves(v)[0].shape[0]
                out[k] = [_meta_tree(v, True) for _ in range(L)]
            else:
                out[k] = _meta_tree(v, layer_axis)
        return out
    shape = node.shape[1:] if layer_axis else node.shape
    return torch.empty(shape, device="meta")


def _ref_at(tree, keys):
    for k in keys:
        tree = tree[k]
    return tuple(tree)


def _drop(spec, i):
    return spec[:i] + spec[i + 1:]


CASES = [(1, None, False), (2, None, False), (4, None, False),
         (2, FSDP, False), (4, None, True)]


@pytest.mark.parametrize("shards,fsdp,tied", CASES,
                         ids=["m1", "m2", "m4", "m2-fsdp", "m4-tied"])
@pytest.mark.parametrize("arch", _archs())
def test_param_and_state_specs_equal_the_references(arch, shards, fsdp,
                                                    tied):
    shapes = _shapes(arch)
    params = _meta_tree(shapes)
    want = jshard.ranl_state_pspecs(shapes, shards, fsdp, tied)
    want_p = jshard.params_pspecs(shapes, shards, fsdp, tied)
    got = tshard.ranl_state_pspecs(params, shards, fsdp, tied)
    got_p = tshard.params_pspecs(params, shards, fsdp, tied)
    assert got["step"] == tuple(want["step"]) == ()
    L = num_layers(params)
    n = 0
    for keys, layered in leaf_paths(params):
        ref_p = _ref_at(want_p, keys)
        ref_h = _ref_at(want["precond"], keys)
        ref_m = _ref_at(want["memory"], keys)
        for q in (range(L) if layered else (None,)):
            p = get(got_p, keys, q)
            if layered:
                assert ref_p[0] is None and ref_m[1] is None, keys
                assert p == _drop(ref_p, 0), (keys, p, ref_p)
                assert get(got["precond"], keys, q) == _drop(ref_h, 0)
                assert get(got["memory"], keys, q) == _drop(ref_m, 1)
            else:
                assert p == ref_p, (keys, p, ref_p)
                assert get(got["precond"], keys, q) == ref_h
                assert get(got["memory"], keys, q) == ref_m
            assert len(p) == get(params, keys, q).ndim
            n += 1
    assert n > 0
    if shards > 1 and not fsdp:
        # "model" lands only on a dim it divides
        for keys, layered in leaf_paths(params):
            leaf = get(params, keys, 0 if layered else None)
            d = tshard.model_dim(get(got_p, keys, 0 if layered else None))
            assert d is None or leaf.shape[d] % shards == 0


@pytest.mark.parametrize("batch,shards", [(8, 1), (8, 2), (8, 4), (6, 4)])
def test_batch_specs_equal_the_references(batch, shards):
    shapes = {"tokens": jax.ShapeDtypeStruct((batch, 16), "int32"),
              "labels": jax.ShapeDtypeStruct((batch, 16), "int32"),
              "patch_embeds": jax.ShapeDtypeStruct((batch, 4, 8), "float32"),
              "pos": jax.ShapeDtypeStruct((), "int32")}
    want = jshard.batch_pspecs(shapes, batch_shards=shards)
    got = tshard.batch_pspecs({k: torch.empty(v.shape, device="meta")
                               for k, v in shapes.items()}, shards)
    assert got == {k: tuple(v) for k, v in want.items()}


def test_worker_prefix_strips_the_batch_axes():
    P = jax.sharding.PartitionSpec
    for spec in [(None, "model"), (("model", "pod", "data"), None),
                 (("pod", "data"), "model"), ("data",), ()]:
        want = tuple(jshard.worker_prefix(P(*spec)))
        assert tshard.worker_prefix(spec) == want, spec


def test_local_shards_put_back_together():
    t = torch.arange(24.0).reshape(2, 4, 3)
    pieces = [tshard.local_shard(t, 1, r, 2) for r in range(2)]
    assert pieces[0].shape == (2, 2, 3)
    assert torch.equal(tshard.gather_shards(pieces, 1), t)
    assert tshard.local_shard(t, None, 1, 2) is t
    assert tshard.model_dim((None, ("model", "data"))) == 1
    assert tshard.model_dim((None, None)) is None


@pytest.fixture
def world_of_one(tmp_path, monkeypatch):
    import torch.distributed as dist
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_make_engine_mesh_at_world_size_one(world_of_one):
    mesh = tmesh.make_engine_mesh(1, device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.mesh.shape) == (1, 1)
    assert tmesh.data_shards(mesh) == tmesh.model_shards(mesh) == 1
    pods = tmesh.make_engine_mesh(1, 1, pods=1, device_type="cpu")
    assert pods.mesh_dim_names == ("data", "model")


@pytest.mark.parametrize("shape", [(2, 1, 1), (1, 2, 1), (1, 1, 2)])
def test_make_engine_mesh_refuses_a_world_that_does_not_match(world_of_one,
                                                              shape):
    data, model, pods = shape
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        tmesh.make_engine_mesh(data, model, pods=pods, device_type="cpu")


def test_mesh_extents_of_a_pod_mesh():
    """``data_shards``/``model_shards`` read any mesh's extents (a stand-in
    with the DeviceMesh interface)."""
    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        _shape = (2, 3, 4)

        def size(self, i):
            return self._shape[i]
    assert tmesh.data_shards(Mesh()) == 6
    assert tmesh.model_shards(Mesh()) == 4
    Mesh.mesh_dim_names, Mesh._shape = ("data",), (5,)
    assert tmesh.data_shards(Mesh()) == 5 and tmesh.model_shards(Mesh()) == 1
