"""The host client store on a mesh and checkpoint and resume on a mesh in
the port (``--clientstore host`` with ``--num_devices``/``--mesh``;
runtime/fed_model.py ``_gather_states``/``_store_writeback``,
parallel/rows.py ``sum_owned_rows``/``all_slot_rows``,
runtime/checkpoint.py), on launched gloo ranks, against the JAX
package.

A narrow ResNet9 (channels 8/16/16/16, d = 15 832) through
``FedModel``/``FedOptimizer`` on 8 clients, W = 4 a round, B = 2, three
rounds, round 2 with a dead slot (tests/torch_mesh_workers.py
``store_runs``). Configurations: local_topk with local momentum and
error, true_topk with ``--topk_down`` (the stale-weights rows), fedavg
(no rows) on the 1-D mesh of 2 ranks; uncompressed with local momentum,
virtual momentum and ``--topk_down`` on it and on ``--mesh 1x2`` (the
2-D dense server's windows). The 2-D mesh admits sketch and
uncompressed modes only (reference config.py:752-768), so the other
three do not run on ``1x2``.

- **Placement.** The host store's rounds are the device placement's on
  the same mesh bit for bit: the weights every round, the losses and
  bytes, and every client's state rows at the end (each rank's owned
  rows); each rank's store owns ``shard_range(8, rank, 2)``.
- **The reference.** The world-2 host-store rounds match the JAX
  package's one-device host-store round within
  tests/test_torch_mesh_clients.py's tolerance (losses rtol 1e-5,
  weights and rows rtol 1e-4 atol 1e-6, bytes exactly).
- **The shard helpers** ``_shard_file``, ``_prune_stale_shards`` and
  ``_merged_store_shard`` give the reference's results on the same
  files.
- **Archives across packages.** The port restores the reference's
  two-process archive (a one-process archive split into a main archive
  and a side shard, as tests/test_elastic.py:231-285 crafts it), on one
  device (merged) and on two ranks (a shard each); the reference's
  ``load_checkpoint`` restores the port's two-rank archive. The rows,
  weights and server state come through bit for bit.
- **Resume.** On two ranks, a run saved after round 1 and resumed in a
  new model is the uninterrupted run bit for bit, for both placements;
  a 2 -> 1 restore (both placements, and the 2-D dense server's windows
  from ``1x2``) and a 1 -> 2 restore give the saved state bit for bit.
- **Autosave retention** (``RoundAutosaver``, keep 2): each history
  snapshot has its side shard, validates, and the oldest is removed
  with its shard.
- **A failed write fails every rank** with its reason: rank 1's side
  shard, then rank 0's archive, made to raise ``OSError``; the other
  rank raises ``RuntimeError`` naming the rank and the error, instead
  of going on (the reference's barrier and broadcast, :425-445).
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_workers as workers
from commefficient_tpu.clientstore.store import shard_range as jax_range
from commefficient_tpu.config import Config as JaxConfig
from commefficient_tpu.models.resnet9 import ResNet9 as JaxResNet9
from commefficient_tpu.parallel.mesh import make_mesh
from commefficient_tpu.runtime import checkpoint as jck
from commefficient_tpu.runtime.fed_model import FedModel as JaxFedModel
from commefficient_tpu.runtime.fed_model import FedOptimizer as JaxFedOpt
from commefficient_tpu.train import cv_train as jax_cv_train
from commefficient_tpu_torch.clientstore import shard_range
from commefficient_tpu_torch.models.resnet9 import ResNet9
from commefficient_tpu_torch.parallel.mesh import launch
from commefficient_tpu_torch.runtime import checkpoint as pck

SPEC = {"prep": 8, "layer1": 16, "layer2": 16, "layer3": 16}
NC, W, B, SEED, LR, ROUNDS = 8, 4, 2, 0, 0.1, 3
CV = dict(weight_decay=5e-4, num_workers=W, local_batch_size=B, k=50,
          num_rows=5, num_cols=512, seed=SEED, dataset_name="Synthetic")
CONFIGS = {
    "local_topk": dict(CV, mode="local_topk", error_type="local",
                       local_momentum=0.9),
    "topk_down": dict(CV, mode="true_topk", error_type="virtual",
                      local_momentum=0.0, virtual_momentum=0.9,
                      do_topk_down=True),
    "fedavg": dict(CV, mode="fedavg", error_type="none",
                   local_momentum=0.0, local_batch_size=-1),
    "uncompressed": dict(CV, mode="uncompressed", error_type="none",
                         local_momentum=0.9, virtual_momentum=0.9,
                         do_topk_down=True),
}
# (config, topology): the 1-D mesh of 2, or the 1x2 mesh
CASES = [(n, "1d") for n in CONFIGS] + [("uncompressed", "1x2")]
TOPO = {"1d": {"num_devices": 2}, "1x2": {"mesh": "1x2"}}


def _batches():
    rng = np.random.RandomState(SEED + 1)
    out = []
    for rnd in range(ROUNDS):
        mask = np.ones((W, B), np.float32)
        if rnd == 1:
            mask[1] = 0
        out.append({"client_ids": rng.choice(NC, W, replace=False)
                    .astype(np.int32),
                    "x": rng.randn(W, B, 32, 32, 3).astype(np.float32),
                    "y": rng.randint(0, 10, (W, B)).astype(np.int32),
                    "mask": mask})
    return out


def _net():
    jm = JaxResNet9(num_classes=10, channels=SPEC)
    variables = jm.init(jax.random.PRNGKey(SEED), jnp.zeros((1, 32, 32, 3)))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    flat = ResNet9(num_classes=10, channels=SPEC).from_jax_params(
        params).numpy()
    return jm, params, flat


def _jax_model(jm, params, kw, store="host"):
    cfg = JaxConfig(num_clients=NC, clientstore=store, **kw)
    model = JaxFedModel(jm, params, jax_cv_train.make_compute_loss(jm),
                        cfg, padded_batch_size=B,
                        mesh=make_mesh(jax.devices()[:1]))
    return model, JaxFedOpt([{"lr": LR}], cfg)


def _jax_rows(model):
    rows, _ = model.client_store.gather(np.arange(NC, dtype=np.int64))
    return {k: np.array(v) for k, v in rows.items()}


def _jax_rounds(jm, params, kw, batches):
    model, opt = _jax_model(jm, params, kw)
    out = []
    for b in batches:
        met = model(dict(b))
        opt.step()
        out.append({"ps": np.asarray(model.ps_weights), "loss": met[0],
                    "down": met[-2], "up": met[-1]})
    rows = _jax_rows(model)
    model.finalize()
    return out, rows


def _crafted_jax_archive(jm, params, batches, path):
    """The reference's two-process host-store archive: its one-process
    archive split at NC/2 into the main archive and ``.shard1``
    (tests/test_elastic.py:231-285). Returns its rows whole."""
    model, opt = _jax_model(jm, params, CONFIGS["local_topk"])
    for b in batches:
        model(dict(b))
        opt.step()
    jck.save_checkpoint(path, model, opt)
    model.finalize()
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: np.asarray(z[k]) for k in z.files if k != "meta"}
        meta = json.loads(str(z["meta"]))
    ids = arrays["store:ids"]
    fields = [k[len("store:"):] for k in arrays
              if k.startswith("store:") and k != "store:ids"
              and not k.startswith("store:init:")]
    whole = {"ids": ids, **{f: arrays["store:" + f] for f in fields}}
    lo, hi = ids < NC // 2, ids >= NC // 2
    assert lo.any() and hi.any()
    side = {"ids": ids[hi]}
    for f in fields:
        side[f] = arrays["store:" + f][hi]
        arrays["store:" + f] = arrays["store:" + f][lo]
    for k in list(arrays):
        if k.startswith("store:init:"):
            side[k[len("store:"):]] = arrays[k]
    arrays["store:ids"] = ids[lo]
    meta["clientstore"]["processes"] = 2
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)
    np.savez_compressed(f"{path}.shard1.npz", **side)
    return whole, arrays


def _run_kw(name, topo, store):
    return dict(CONFIGS[name], clientstore=store, **TOPO[topo])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh_store"))
    jm, params, flat = _net()
    batches = _batches()
    b0, rest = batches[0], batches[1:]
    p = {k: os.path.join(tmp, f"{k}.npz") for k in (
        "w2_host", "w2_dev", "w1_host", "w1_dev", "x2d_host", "jax2",
        "hist")}
    os.makedirs(p["hist"][:-4])
    # the reference's crafted two-process archive
    jax_whole, jax_main = _crafted_jax_archive(jm, params, batches,
                                               p["jax2"])
    # one device, saved after round 1 (the 1 -> 2 restores)
    one_saves = workers.store_runs(
        [(_run_kw("local_topk", "1d", s) | {"num_devices": 1}, flat,
          [("round", b0), ("save", p[key]), ("snap",)])
         for s, key in (("host", "w1_host"), ("device", "w1_dev"))],
        SPEC, NC, LR)
    # two ranks: every case in both placements; local_topk saved after
    # round 1 on the 1-D mesh, the 1x2 host run after round 3
    saves = {("local_topk", "1d", "host"): (1, "w2_host"),
             ("local_topk", "1d", "device"): (1, "w2_dev"),
             ("uncompressed", "1x2", "host"): (ROUNDS, "x2d_host")}
    runs = {"1d": [], "1x2": []}
    for name, topo in CASES:
        for store in ("device", "host"):
            at, key = saves.get((name, topo, store), (None, None))
            ops = []
            for rnd, b in enumerate(batches):
                ops.append(("round", b))
                if rnd + 1 == at:
                    ops += [("save", p[key]), ("snap",)]
            if at != ROUNDS:
                ops.append(("snap",))
            runs[topo].append(((name, topo, store),
                               (_run_kw(name, topo, store), flat, ops)))
    for store in ("host", "device"):
        key = "host" if store == "host" else "dev"
        runs["1d"].append((("resume", store),
                           (_run_kw("local_topk", "1d", store), flat,
                            [("load", p["w2_" + key]), ("snap",)]
                            + [("round", b) for b in rest]
                            + [("snap",)])))
        runs["1d"].append((("from_one", store),
                           (_run_kw("local_topk", "1d", store), flat,
                            [("load", p["w1_" + key]), ("snap",)])))
    runs["1d"].append((("jax2",), (_run_kw("local_topk", "1d", "host"),
                                   flat, [("load", p["jax2"]),
                                          ("snap",)])))
    runs["1d"].append((("save_fails",),
                       (_run_kw("local_topk", "1d", "host"), flat,
                        [("round", b0),
                         ("save_fails_on", (p["w2_host"] + ".bad", 1)),
                         ("save_fails_on", (p["w2_host"] + ".bad0", 0))])))
    runs["1d"].append((("autosave",),
                       (_run_kw("local_topk", "1d", "host"), flat,
                        [("autosave", (p["hist"][:-4], 2))]
                        + [("round", b) for b in batches])))
    port = {}
    for topo, todo in runs.items():
        outs = launch(2, workers.store_runs, [r[1] for r in todo], SPEC,
                      NC, LR, device_type="cpu")
        port.update({key: [o[i] for o in outs]
                     for i, (key, _) in enumerate(todo)})
    return {"jax": (jm, params), "batches": batches, "flat": flat,
            "paths": p, "port": port, "one_saves": one_saves,
            "jax_whole": jax_whole}


def _whole_rows(ranks, snap=-1):
    """{field: (NC, ...)} from every rank's owned rows of a snapshot."""
    out = {}
    for o in ranks:
        s = o["snaps"][snap]
        for f, rows in s["rows"].items():
            arr = out.setdefault(f, np.full((NC,) + rows.shape[1:], np.nan,
                                            np.float32))
            arr[s["ids"]] = rows
    for f, arr in out.items():
        assert not np.isnan(arr).any(), f"{f}: a client has no owner"
    return out


def _same_rows(a, b):
    assert set(a) == set(b)
    for f in a:
        assert a[f].tobytes() == b[f].tobytes(), f


@pytest.mark.parametrize("name,topo", CASES)
def test_host_store_is_the_device_placement_bit_for_bit(setup, name, topo):
    port = setup["port"]
    dev, host = port[(name, topo, "device")], port[(name, topo, "host")]
    for d, h in zip(dev, host):
        assert len(h["rounds"]) == ROUNDS
        for rd, rh in zip(d["rounds"], h["rounds"]):
            assert rd["ps"].tobytes() == rh["ps"].tobytes()
            np.testing.assert_array_equal(rd["loss"], rh["loss"])
            np.testing.assert_array_equal(rd["down"], rh["down"])
            np.testing.assert_array_equal(rd["up"], rh["up"])
        assert h["rounds"][-1]["ps"].tobytes() == \
            host[0]["rounds"][-1]["ps"].tobytes()
    _same_rows(_whole_rows(dev), _whole_rows(host))
    # the exchange ran and was timed where there are rows
    if _whole_rows(host):
        for h in host:
            t = h["timings"][-1]
            assert t["exchange_bytes"] > 0 and t["wb_exchange_bytes"] > 0
            assert t["exchange_s"] >= 0 and t["wb_exchange_s"] >= 0


@pytest.mark.parametrize("name,topo", CASES)
def test_each_rank_owns_its_shard_range(setup, name, topo):
    for rank, o in enumerate(setup["port"][(name, topo, "host")]):
        assert o["rank"] == rank
        assert o["store_owned"] == shard_range(NC, rank, 2) == \
            jax_range(NC, rank, 2)
    for n in (1, 2, 3, 4, 7):
        for nc in (1, 7, 8, 10):
            for r in range(n):
                assert shard_range(nc, r, n) == jax_range(nc, r, n)


_JAX = {}


@pytest.mark.parametrize("name,topo", CASES)
def test_host_store_mesh_rounds_match_the_reference(setup, name, topo):
    jm, params = setup["jax"]
    if name not in _JAX:
        _JAX[name] = _jax_rounds(jm, params, CONFIGS[name],
                                 setup["batches"])
    want, want_rows = _JAX[name]
    ranks = setup["port"][(name, topo, "host")]
    for jr, tr in zip(want, ranks[0]["rounds"]):
        np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=1e-5)
        np.testing.assert_allclose(tr["ps"], jr["ps"], rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_array_equal(tr["up"], jr["up"])
        np.testing.assert_array_equal(tr["down"], jr["down"])
    got = _whole_rows(ranks)
    assert set(got) == set(want_rows)
    for f in got:
        np.testing.assert_allclose(got[f], want_rows[f], rtol=1e-4,
                                   atol=1e-6, err_msg=f)


def test_shard_helpers_are_the_reference(tmp_path):
    rng = np.random.RandomState(3)
    results = []
    for pkg, d in ((pck, tmp_path / "port"), (jck, tmp_path / "ref")):
        d.mkdir()
        path = str(d / "ck.npz")
        assert pkg._shard_file(path, 3) == path + ".shard3.npz"
        ids = [np.array([0, 2], np.int64), np.array([4], np.int64),
               np.array([], np.int64)]
        rows = [rng.randn(len(i), 3, 5).astype(np.float32) for i in ids]
        rng = np.random.RandomState(3)
        init = np.arange(5, dtype=np.float32)
        np.savez_compressed(path, meta=json.dumps({}), **{
            "store:ids": ids[0], "store:velocities": rows[0],
            "store:init:weights": init, "ps_weights": np.zeros(4)})
        for k in (1, 2):
            np.savez_compressed(pkg._shard_file(path, k), ids=ids[k],
                                velocities=rows[k], **{"init:weights": init})
        for k in (3, 4):
            np.savez_compressed(pkg._shard_file(path, k), ids=ids[2])
        with np.load(path) as z:
            merged = pkg._merged_store_shard(path, z, 3)
        pkg._prune_stale_shards(path, 3)
        results.append((merged, sorted(os.listdir(d))))
    (mp, lp), (mr, lr) = results
    assert lp == lr == ["ck.npz", "ck.npz.shard1.npz", "ck.npz.shard2.npz"]
    assert set(mp) == set(mr) == {"ids", "velocities", "init:weights"}
    for k in mp:
        assert mp[k].dtype == mr[k].dtype
        assert mp[k].tobytes() == mr[k].tobytes(), k


def test_port_restores_the_reference_two_process_archive(setup):
    whole = setup["jax_whole"]
    ranks = setup["port"][("jax2",)]
    got = _whole_rows(ranks)
    for f in got:
        want = np.full_like(got[f], np.nan)
        # never-written clients come back as the init rows (zeros here)
        want[:] = 0.0
        want[whole["ids"]] = whole[f]
        assert got[f].tobytes() == want.tobytes(), f
    with np.load(setup["paths"]["jax2"]) as z:
        ps = np.asarray(z["ps_weights"])
        ss = np.asarray(z["ss_Vvelocity"])
    for o in ranks:
        assert o["snaps"][0]["ps"].tobytes() == ps.tobytes()
        assert o["snaps"][0]["ss"][0].tobytes() == ss.tobytes()
    # and on one device, the shards merged
    one = workers.store_runs(
        [(_run_kw("local_topk", "1d", "host") | {"num_devices": 1},
          setup["flat"], [("load", setup["paths"]["jax2"]), ("snap",)])],
        SPEC, NC, LR)
    _same_rows(_whole_rows(one), got)


def test_reference_restores_the_port_two_rank_archive(setup):
    jm, params = setup["jax"]
    path = setup["paths"]["w2_host"]
    meta = pck.validate_checkpoint(path)
    assert meta["clientstore"]["processes"] == 2
    assert os.path.exists(path + ".shard1.npz")
    model, opt = _jax_model(jm, params, CONFIGS["local_topk"])
    jck.load_checkpoint(path, model, opt)
    saved = setup["port"][("local_topk", "1d", "host")]
    _same_rows(_jax_rows(model), _whole_rows(saved, 0))
    assert np.asarray(model.ps_weights).tobytes() == \
        saved[0]["snaps"][0]["ps"].tobytes()
    model.finalize()


@pytest.mark.parametrize("store", ["host", "device"])
def test_same_world_resume_is_bit_exact(setup, store):
    port = setup["port"]
    saved = port[("local_topk", "1d", store)]
    resumed = port[("resume", store)]
    for s, r in zip(saved, resumed):
        a, b = s["snaps"][0], r["snaps"][0]
        assert a["ps"].tobytes() == b["ps"].tobytes()
        for x, y in zip(a["ss"], b["ss"]):
            assert x.tobytes() == y.tobytes()
        assert (a["last_updated"] == b["last_updated"]).all()
        assert (a["client_last_seen"] == b["client_last_seen"]).all()
        assert a["round_index"] == b["round_index"] == 1
        for rs, rr in zip(s["rounds"][1:], r["rounds"]):
            assert rs["ps"].tobytes() == rr["ps"].tobytes()
            np.testing.assert_array_equal(rs["down"], rr["down"])
    _same_rows(_whole_rows(saved, 0), _whole_rows(resumed, 0))
    _same_rows(_whole_rows(saved), _whole_rows(resumed))


def _one_device_load(setup, name, store, path):
    return workers.store_runs(
        [(dict(CONFIGS[name], clientstore=store, num_devices=1),
          setup["flat"], [("load", path), ("snap",)])], SPEC, NC, LR)


@pytest.mark.parametrize("case", ["host", "device", "dense_1x2"])
def test_two_to_one_restore_gives_the_saved_state(setup, case):
    port = setup["port"]
    if case == "dense_1x2":
        saved = port[("uncompressed", "1x2", "host")]
        one = _one_device_load(setup, "uncompressed", "host",
                               setup["paths"]["x2d_host"])
        snap = -1
        # each rank held a window of the momentum
        assert saved[0]["snaps"][-1]["ss_local_shape"] == (
            -(-saved[0]["snaps"][-1]["ss"][0].shape[0] // 2),)
    else:
        key = "w2_host" if case == "host" else "w2_dev"
        saved = port[("local_topk", "1d", case)]
        one = _one_device_load(setup, "local_topk", case,
                               setup["paths"][key])
        snap = 0
    a, b = saved[0]["snaps"][snap], one[0]["snaps"][0]
    assert a["ps"].tobytes() == b["ps"].tobytes()
    for x, y in zip(a["ss"], b["ss"]):
        assert x.tobytes() == y.tobytes()
    assert (a["last_updated"] == b["last_updated"]).all()
    _same_rows(_whole_rows(saved, snap), _whole_rows(one))


@pytest.mark.parametrize("store", ["host", "device"])
def test_one_to_two_restore_gives_the_saved_state(setup, store):
    one = setup["one_saves"][0 if store == "host" else 1]
    ranks = setup["port"][("from_one", store)]
    a = one["snaps"][0]
    for o in ranks:
        b = o["snaps"][0]
        assert a["ps"].tobytes() == b["ps"].tobytes()
        for x, y in zip(a["ss"], b["ss"]):
            assert x.tobytes() == y.tobytes()
    _same_rows(_whole_rows([one]), _whole_rows(ranks))


def test_autosave_retention_links_side_shards(setup):
    d = setup["paths"]["hist"][:-4]
    names = sorted(os.listdir(d))
    hist = [pck.history_file(d, "t", r) for r in (2, 3)]
    want = sorted(["ckpt_t.npz", "ckpt_t.npz.shard1.npz"]
                  + [os.path.basename(h) for h in hist]
                  + [os.path.basename(h) + ".shard1.npz" for h in hist])
    assert names == want
    for h in hist:
        assert pck.validate_checkpoint(h)["clientstore"]["processes"] == 2
        assert jck.validate_checkpoint(h)["round_index"] in (2, 3)


def test_a_failed_write_fails_every_rank_with_its_reason(setup):
    ranks = setup["port"][("save_fails",)]
    # the first save's write fails on rank 1 (its side shard), the
    # second's on rank 0 (the archive)
    for i, bad in enumerate((1, 0)):
        for o in ranks:
            kind, text = o["snaps"][i]
            if o["rank"] == bad:
                assert kind == "OSError" and "No space left" in text
            else:
                assert kind == "RuntimeError"
                assert f"failed on rank(s) {bad} (OSError" in text


def test_owned_rows_cross_bit_for_bit():
    """The store's exchange (``sum_owned_rows``, ``all_slot_rows``) on 2
    gloo ranks keeps an owner's bits, a -0.0 included (a float sum of
    zeros would make it +0.0): sharded (W = 4, each rank its 2 slots)
    and unsharded (W = 3, every rank all three)."""
    rows = np.array([[-0.0, 1.5, -2.0], [3.0, -0.0, 0.0],
                     [-0.0, -0.0, 7.25], [1e-40, -1e-40, 0.5]], np.float32)
    cases = [(rows, [0, 1, 1, 0]), (rows[:3], [1, 0, 1])]
    outs = launch(2, workers.owned_rows_exchange, cases,
                  {"num_devices": 2}, device_type="cpu")
    for rank, res in enumerate(outs):
        (mine4, all4), (mine3, all3) = res
        assert mine4.tobytes() == rows[2 * rank:2 * rank + 2].tobytes()
        assert all4.tobytes() == rows.tobytes()
        assert mine3.tobytes() == all3.tobytes() == rows[:3].tobytes()
