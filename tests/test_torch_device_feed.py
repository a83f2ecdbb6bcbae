"""The port's device feed (``Dataset``/``DataIterator.iter_torch_batches``
with ``device=`` or ``sharding=``, over ``data/streaming.py::
torch_device_feed``) held against the JAX package's ``iter_jax_batches``
on the CPU.

The same numpy data go through both packages' Data, each in a cluster of
its own in this process: ``tests/test_data.py``'s four device-feed cases
(values and order, the ``sharding=`` split, ``drop_last`` under a
sharding, the DataIterator feed), the upload window at
``device_prefetch`` 0, 1 and 2, the ``sharding=`` split on two gloo ranks
of a ``TorchTrainer`` against the rows ``NamedSharding(mesh,
PartitionSpec("dp"))`` puts on each device of a two-device CPU mesh, and
the slice as a whole: a one-worker ``TorchTrainer`` whose ViT steps read
their batches through the feed, against ``ray_tpu``'s ViT step on the
same batches from the same weights. On a card the feed uploads through
pinned memory on a side stream; ``chip_smoke.py`` drives that path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import ray_tpu
import ray_tpu.data as jdata
import ray_tpu_torch as rt
from ray_tpu.data import streaming as jstreaming
from ray_tpu_torch import data as tdata
from ray_tpu_torch.data import streaming as tstreaming
from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

TIMEOUT = 120


@pytest.fixture(scope="module")
def clusters():
    ray_tpu.init(num_cpus=4, ignore_reinit_error=True)
    rt.init(num_cpus=4)
    yield
    rt.shutdown()
    ray_tpu.shutdown()


def _times3(b):
    return {"x": b["id"].astype(np.float32) * 3}


# ---------------------------------------------------------------------------
# tests/test_data.py's device-feed cases, on both packages
# ---------------------------------------------------------------------------
def test_iter_torch_batches_device_resident(clusters):
    """Batches come back on the device asked for, correct and in the JAX
    package's order, with uploads pipelined ``device_prefetch`` deep."""
    ours = [b["x"] for b in tdata.range(1024, override_num_blocks=4)
            .map_batches(_times3)
            .iter_torch_batches(batch_size=256, device="cpu",
                                device_prefetch=2)]
    theirs = [b["x"] for b in jdata.range(1024, override_num_blocks=4)
              .map_batches(_times3)
              .iter_jax_batches(batch_size=256, device_prefetch=2)]
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in ours)
    assert all(isinstance(a, jax.Array) for a in theirs)
    assert len(ours) == len(theirs) == 4
    for t, a in zip(ours, theirs):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    np.testing.assert_allclose(np.sort(torch.cat(ours).numpy()),
                               3.0 * np.arange(1024, dtype=np.float32))


def test_sharding_requires_drop_last_in_the_jax_package(clusters):
    # The port's side runs on a real mesh in _shard_loop below.
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    with pytest.raises(ValueError, match="drop_last"):
        next(iter(jdata.range(100).iter_jax_batches(
            batch_size=16, sharding=NamedSharding(mesh, PartitionSpec("dp"))
        )))


def test_data_iterator_iter_torch_batches(clusters):
    ours, theirs = [], []
    (it,) = tdata.range(256, override_num_blocks=4).streaming_split(1)
    for batch in it.iter_torch_batches(batch_size=64, device="cpu",
                                       device_prefetch=1):
        assert isinstance(batch["id"], torch.Tensor)
        ours.append(batch["id"].numpy())
    (jit,) = jdata.range(256, override_num_blocks=4).streaming_split(1)
    for batch in jit.iter_jax_batches(batch_size=64, device_prefetch=1):
        theirs.append(np.asarray(batch["id"]))
    assert sorted(np.concatenate(ours).tolist()) == list(range(256))
    assert [a.tolist() for a in ours] == [a.tolist() for a in theirs]


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_prefetch_window(depth):
    """How many batches each feed has pulled from its source when it
    yields each batch: the window of ``device_prefetch``."""
    def source(pulled, n=5):
        for i in range(n):
            pulled.append(i)
            yield {"x": np.full((2, 3), i, np.float32)}

    def window(feed):
        pulled = []
        seen = []
        for batch in feed(source(pulled)):
            seen.append((len(pulled), float(np.asarray(batch["x"])[0, 0])))
        return seen

    ours = window(lambda s: tstreaming.torch_device_feed(
        s, device="cpu", device_prefetch=depth))
    theirs = window(lambda s: jstreaming.jax_device_feed(
        s, device=jax.devices()[0], device_prefetch=depth))
    assert ours == theirs == [(min(i + depth + 1, 5), float(i))
                              for i in range(5)]


def test_feed_arguments_raise_as_the_jax_feeds_do():
    for feed in (lambda **kw: tstreaming.torch_device_feed(iter(()), **kw),
                 lambda **kw: list(jstreaming.jax_device_feed(iter(()),
                                                              **kw))):
        with pytest.raises(ValueError, match="device_prefetch"):
            feed(device_prefetch=-1)
        with pytest.raises(ValueError, match="not both"):
            feed(device="cpu", sharding=object())


def test_cuda_without_a_card_raises(clusters):
    assert not torch.cuda.is_available()
    ds = tdata.range(8)
    (it,) = tdata.range(8).streaming_split(1)
    for iterate in (ds.iter_torch_batches, it.iter_torch_batches):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            iterate(batch_size=4, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstreaming.torch_device_feed(iter(()))  # device=None: the card
    # Without device= the host iterator, as the reference has it.
    batch = next(iter(ds.iter_torch_batches(batch_size=4)))
    assert batch["id"].device.type == "cpu"


# ---------------------------------------------------------------------------
# sharding= on two gloo ranks, against NamedSharding on two CPU devices
# ---------------------------------------------------------------------------
SHARD_BATCH = 32


def _shard_loop(config):
    import torch.distributed as dist

    from ray_tpu_torch import data, train
    from ray_tpu_torch.parallel import MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(dp=2))
    ds = data.from_numpy(config["x"], column="x", override_num_blocks=2)
    batches = [b["x"] for b in ds.iter_torch_batches(
        batch_size=SHARD_BATCH, sharding=mesh, drop_last=True)]
    raised = {}
    for name, kwargs in (("drop_last", {}),
                         ("both", {"device": "cpu", "drop_last": True})):
        try:
            ds.iter_torch_batches(batch_size=16, sharding=mesh, **kwargs)
            raised[name] = None
        except ValueError as e:
            raised[name] = str(e)
    mine = {"rank": train.get_context().world_rank,
            "devices": sorted({str(b.device) for b in batches}),
            "rows": [b.numpy() for b in batches], "raised": raised}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    train.report({"ranks": ranks})


def test_sharding_over_two_gloo_ranks_matches_named_sharding(clusters,
                                                             tmp_path):
    x = np.random.default_rng(3).standard_normal(200).astype(np.float32)
    result = TorchTrainer(
        _shard_loop, train_loop_config={"x": x},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="shard", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None, result.error
    ranks = result.metrics["ranks"]

    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    sharding = NamedSharding(mesh, PartitionSpec("dp"))
    shards = []  # per batch: the rows on device 0, on device 1
    for batch in jdata.from_numpy(x, column="x", override_num_blocks=2) \
            .iter_jax_batches(batch_size=SHARD_BATCH, sharding=sharding,
                              drop_last=True):
        assert batch["x"].sharding == sharding
        by_device = sorted(batch["x"].addressable_shards,
                           key=lambda s: s.device.id)
        shards.append([np.asarray(s.data) for s in by_device])
    assert len(shards) == 200 // SHARD_BATCH
    for r, got in enumerate(ranks):
        assert got["rank"] == r and got["devices"] == ["cpu"]
        assert len(got["rows"]) == len(shards)
        for ours, theirs in zip(got["rows"], shards):
            assert ours.shape == (SHARD_BATCH // 2,)
            np.testing.assert_array_equal(ours, theirs[r])
        assert "drop_last" in got["raised"]["drop_last"]
        assert "not both" in got["raised"]["both"]


# ---------------------------------------------------------------------------
# The slice as a whole: the ViT step in a Train worker, fed by the feed
# ---------------------------------------------------------------------------
FEED_STEPS, FEED_BATCH = 3, 4
# tests/test_torch_models.py's f32 ViT band: the loss within 1e-5 of
# JAX's, relative, and each param within 2e-5 of max(|jax|, 1) (AdamW
# moves a weight by about lr a step whatever its gradient).
LOSS_RTOL, PARAM_TOL = 1e-5, 2e-5


def _vit_feed_loop(config):
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import from_jax_params
    from ray_tpu_torch.models.vit import ViTConfig, make_vit_train_step

    torch.set_num_threads(2)
    cfg = ViTConfig(dtype=torch.float32, **config["cfg"])
    init_state, train_step = make_vit_train_step(cfg, device="cpu")
    state = init_state(params=from_jax_params(config["params"], "cpu"))
    losses, images, labels, devices = [], [], [], set()
    for batch in train.get_dataset_shard("train").iter_torch_batches(
            batch_size=FEED_BATCH, device="cpu", device_prefetch=2,
            drop_last=True):
        devices.update(str(t.device) for t in batch.values())
        images.append(batch["image"].numpy().copy())
        labels.append(batch["label"].numpy().copy())
        state, m = train_step(state, (batch["image"], batch["label"]))
        losses.append(float(m["loss"]))
    params = {k: v for k, v in state["params"].items()}
    train.report({"losses": losses, "images": images, "labels": labels,
                  "devices": sorted(devices),
                  "params": _to_numpy(params)})


def _to_numpy(params):
    if isinstance(params, dict):
        return {k: _to_numpy(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_to_numpy(v) for v in params]
    return params.detach().float().numpy()


def test_vit_train_step_fed_by_the_feed_matches_jax(clusters, tmp_path):
    from ray_tpu.models import vit as jvit

    jcfg = dataclasses.replace(jvit.ViTConfig.tiny(), dtype=jnp.float32)
    j_init_state, j_step = jvit.make_vit_train_step(jcfg, donate=False)
    jstate = j_init_state(jax.random.PRNGKey(11))
    start = jax.tree.map(np.asarray, jstate["params"])
    rng = np.random.default_rng(11)
    n = FEED_STEPS * FEED_BATCH
    images = rng.standard_normal(
        (n, jcfg.image_size, jcfg.image_size, jcfg.channels)
    ).astype(np.float32)
    labels = rng.integers(0, jcfg.num_classes, n)
    jlosses = []
    for i in range(FEED_STEPS):
        rows = slice(i * FEED_BATCH, (i + 1) * FEED_BATCH)
        jstate, jm = j_step(jstate, (jnp.asarray(images[rows]),
                                     jnp.asarray(labels[rows])))
        jlosses.append(float(jm["loss"]))

    ds = tdata.from_numpy(images, column="image",
                          override_num_blocks=FEED_STEPS).zip(
        tdata.from_numpy(labels, column="label",
                         override_num_blocks=FEED_STEPS))
    cfg = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
           if f.name != "dtype"}
    result = TorchTrainer(
        _vit_feed_loop, train_loop_config={"cfg": cfg, "params": start},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="vit_feed", storage_path=str(tmp_path)),
        datasets={"train": ds},
    ).fit()
    assert result.error is None, result.error
    m = result.metrics
    assert m["devices"] == ["cpu"]
    np.testing.assert_array_equal(np.concatenate(m["images"]), images)
    np.testing.assert_array_equal(np.concatenate(m["labels"]), labels)
    assert len(m["losses"]) == FEED_STEPS
    for ours, theirs in zip(m["losses"], jlosses):
        assert abs(ours - theirs) <= LOSS_RTOL * abs(theirs)
    for t, j in zip(jax.tree.leaves(m["params"]),
                    jax.tree.leaves(jstate["params"])):
        j = np.asarray(j, np.float32)
        assert np.abs(t - j).max() <= PARAM_TOL * max(np.abs(j).max(), 1.0)
