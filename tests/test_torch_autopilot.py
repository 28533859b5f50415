"""The compression autopilot and its round variants
(``commefficient_tpu_torch/autopilot/``, the variant cache of
``runtime/fed_model.py``) against the JAX package.

- Keys, ladders, wire bytes, bands and ``apply_knobs`` equal the
  reference's for the same configs; ``round_plan``'s ``autopilot`` block
  is the reference's.
- Both controllers, fed one observation stream, give equal trajectories
  and records; ``replay_record`` and ``python -m
  commefficient_tpu_torch.autopilot.replay`` reproduce them.
- A port FedModel against the JAX FedModel under ``--autopilot on`` on
  ``test_modes.linear_loss`` (the dtype walk, and the geometry walk that
  re-seeds the server's tables): the variant key is the same every
  round, probes and weights agree at rtol 1e-5 / atol 1e-6, and each
  round's ledger counters (``vcompile_*:<key>``, ``autopilot_moves``)
  have the reference's names. Rounding could move a decision where a
  recovery error sits within rounding of LO or HI, so the bands are
  picked at least 0.05 from every observed error, and the test asserts
  that margin.
- The port's own bit-for-bit checks: the autopilot off (the base
  variant's config is ``args`` itself), pinned against the static
  config, a switched variant against a fresh build, and warm-ahead
  never building an unvisited point.
- The knob-mutation rule: an AST scan of the port finds no write to a
  compression knob outside ``autopilot/`` and ``config.py``.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import ast
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu import autopilot as jax_ap
from commefficient_tpu.autopilot import controller as jax_controller
from commefficient_tpu.config import parse_args as jax_parse_args
from commefficient_tpu.core.rounds import round_plan as jax_round_plan
from commefficient_tpu.parallel.mesh import make_mesh
from commefficient_tpu.runtime.fed_model import FedModel as JaxFedModel
from commefficient_tpu.runtime.fed_model import FedOptimizer as JaxFedOpt
from commefficient_tpu_torch import autopilot as ap
from commefficient_tpu_torch.autopilot import controller, replay
from commefficient_tpu_torch.config import Config, parse_args
from commefficient_tpu_torch.core.rounds import (ClientStates,
                                                 build_client_round,
                                                 round_plan)
from commefficient_tpu_torch.runtime.fed_model import FedModel, FedOptimizer

from test_torch_modes import torch_linear_loss

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
MARGIN = 0.05

# command lines whose lattices the packages must agree on
ARGVS = {
    "f32": ["--k", "16", "--num_rows", "3", "--num_cols", "128"],
    "bf16": ["--sketch_dtype", "bf16", "--num_cols", "4096"],
    "fp8": ["--sketch_dtype", "fp8"],
    "geometry": ["--autopilot_geometry", "--num_cols", "1000"],
    "geometry_int8": ["--autopilot_geometry", "--sketch_dtype", "int8",
                      "--num_cols", "768", "--approx_recall", "0.5"],
    "dp": ["--dp", "sketch", "--dp_noise_mult", "1.2", "--dp_epsilon",
           "6", "--autopilot_geometry", "--num_workers", "4",
           "--num_clients", "100", "--num_cols", "512"],
}
ON = ["--autopilot", "on", "--autopilot_band", "0.05:0.6",
      "--probe_every", "1"]


def _both(argv):
    return parse_args(argv=argv), jax_parse_args(None, argv)


# --- the lattice -----------------------------------------------------------


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_lattice_is_the_references(name):
    ours, theirs = _both(ARGVS[name])
    ladder, jladder = ap.build_ladder(ours), jax_ap.build_ladder(theirs)
    assert [ap.key_str(k) for k in ladder] == \
        [jax_ap.key_str(k) for k in jladder]
    assert tuple(ap.key_of(ours)) == tuple(jax_ap.key_of(theirs))
    for key, jkey in zip(ladder, jladder):
        assert ap.variant_bytes(key) == jax_ap.variant_bytes(jkey)
        assert ap.parse_key(ap.key_str(key)) == key
        moved, jmoved = ap.apply_knobs(ours, key), \
            jax_ap.apply_knobs(theirs, jkey)
        for field in ("sketch_dtype", "k", "num_rows", "num_cols",
                      "approx_recall", "dp_noise_mult", "grad_size"):
            assert getattr(moved, field) == getattr(jmoved, field), field
        assert ap.key_of(moved) == key
        assert (moved is ours) == (jmoved is theirs) == \
            (key == ladder[0])
        assert float(moved.upload_wire_bytes_per_client) == \
            ap.variant_bytes(key)
    costs = [ap.variant_bytes(k) for k in ladder]
    assert costs == sorted(costs, reverse=True) and len(set(costs)) == \
        len(costs)


def test_apply_knobs_rescales_dp_noise_as_the_reference():
    ours, theirs = _both(ARGVS["dp"])
    key = ap.key_of(ours)._replace(rows=2, cols=64)
    got = ap.apply_knobs(ours, key)
    want = jax_ap.apply_knobs(theirs, jax_ap.VariantKey(*key))
    assert got.dp_noise_mult == want.dp_noise_mult == \
        pytest.approx(1.2 * (5 / 2) ** 0.5)
    # the feasibility predicate filters the same points
    keep, jkeep = controller._budget_feasible(ours), \
        jax_controller._budget_feasible(theirs)
    for k in ap.build_ladder(ours) + [key]:
        assert keep(k) == jkeep(jax_ap.VariantKey(*k))


@pytest.mark.parametrize("band", ["0.2:0.6", "0:1", "1e-3:2.5", "0.6:0.2",
                                  "x", "0.2", "-1:2"])
def test_bands_are_the_references(band):
    try:
        want = jax_ap.parse_band(band)
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            ap.parse_band(band)
        assert str(ours.value) == str(e)
        return
    assert ap.parse_band(band) == want
    assert ap.band_str(want) == jax_ap.band_str(want)


def test_malformed_keys_raise_as_the_reference():
    for bad in ("int8-k5-r3", "int8-x5-r3-c8-re1", "f32-k5-r3-c8-re"):
        with pytest.raises(ValueError):
            ap.parse_key(bad)
        with pytest.raises(ValueError):
            jax_ap.parse_key(bad)


@pytest.mark.parametrize("name", ["f32", "geometry", "dp"])
def test_round_plan_autopilot_block_is_the_references(name):
    argv = ARGVS[name] + ON + ["--autopilot_pin",
                               "int8-k50000-r5-c125000-re9500"]
    ours, theirs = _both(argv)
    ours.grad_size = theirs.grad_size = 10000
    assert round_plan(ours)["autopilot"] == \
        jax_round_plan(theirs)["autopilot"]
    assert "autopilot" not in round_plan(parse_args(argv=ARGVS[name]))


# --- the cache ---------------------------------------------------------------


def test_cache_bound_lru_eviction_counters():
    built, evicted = [], []
    cache = ap.RoundVariantCache(lambda k: built.append(k) or f"v{k}",
                                 max_size=2,
                                 on_evict=lambda k, v: evicted.append(k))
    assert cache.get(1) == "v1" and cache.get(2) == "v2"
    assert cache.get(1) == "v1"                  # hit, 1 becomes MRU
    assert cache.get(3) == "v3"                  # evicts 2 (LRU)
    assert evicted == [2] and cache.keys() == [1, 3]
    assert cache.get(2) == "v2"                  # rebuilt
    assert built == [1, 2, 3, 2]
    assert cache.counters() == {"hits": 1, "misses": 4, "evictions": 2,
                                "size": 2}
    assert 3 in cache and 1 not in cache and len(cache) == 2
    assert cache.peek(3) == "v3" and cache.peek(9) is None
    assert cache.counters()["hits"] == 1         # peek counts nothing
    with pytest.raises(AssertionError):
        ap.RoundVariantCache(lambda k: k, max_size=0)


# --- the controller ----------------------------------------------------------


def _stream(seed, n=40):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        u = rs.rand()
        if u < 0.15:
            out.append({})
        elif u < 0.2:
            out.append({"recovery_error": 0.3, "agg_nan": 1.0})
        elif u < 0.23:
            out.append({"agg_inf": 2.0})
        else:
            out.append({"recovery_error": float(rs.choice(
                [rs.uniform(0, 0.05), rs.uniform(0.05, 0.6),
                 rs.uniform(0.6, 2.0), float("inf")],
                p=[0.55, 0.3, 0.13, 0.02]))})
    return out


@pytest.mark.parametrize("seed,cooldown,start,pinned", [
    (0, 0, 0, False), (1, 1, 0, False), (2, 2, 1, False), (3, 0, 2, True),
    (4, 3, 0, False)])
def test_controllers_give_the_references_trajectories(seed, cooldown, start,
                                                      pinned):
    cfg, jcfg = _both(ARGVS["geometry"])
    ladder, jladder = ap.build_ladder(cfg), jax_ap.build_ladder(jcfg)
    ours = ap.AutopilotController(ladder, (0.05, 0.6), cooldown, seed=seed,
                                  start=start, pinned=pinned)
    theirs = jax_ap.AutopilotController(jladder, (0.05, 0.6), cooldown,
                                        seed=seed, start=start,
                                        pinned=pinned)
    for r, probes in enumerate(_stream(seed)):
        got, want = ours.observe(r, dict(probes)), \
            theirs.observe(r, dict(probes))
        assert (None if got is None else ap.key_str(got)) == \
            (None if want is None else jax_ap.key_str(want))
    rec = ours.record()
    assert json.dumps(rec) == json.dumps(theirs.record())
    assert ap.replay_record(rec) == jax_ap.replay_record(rec)
    if start == 0 or pinned:
        # the record names the ladder's head as the start point
        assert ap.replay_record(rec) == \
            [t["key"] for t in rec["trajectory"]]
    if not pinned:
        assert {t["action"] for t in rec["trajectory"]} >= {"hold"}


@pytest.mark.parametrize("extra", [
    [], ["--autopilot_pin", "int8-k16-r3-c128-re9500"],
    ["--autopilot_pin", "int8-k8-r3-c128-re9500"]], ids=["on", "pin", "off_ladder"])
def test_build_controller_is_the_references(extra):
    ours, theirs = _both(ARGVS["f32"] + ON + extra)
    ctl, jctl = ap.build_controller(ours), jax_ap.build_controller(theirs)
    assert json.dumps(ctl.record()) == json.dumps(jctl.record())
    assert ap.key_str(ctl.key) == jax_ap.key_str(jctl.key)
    assert ap.build_controller(parse_args(argv=ARGVS["f32"])) is None
    assert controller.key_of_config(ours) == ap.key_of(ours)


def test_pin_beyond_the_budget_raises_as_the_reference():
    argv = ARGVS["dp"] + ON + ["--autopilot_pin",
                               "f32-k50000-r10-c512-re9500"]
    ours, theirs = _both(argv)
    with pytest.raises(ValueError, match="ε budget") as e:
        ap.build_controller(ours)
    with pytest.raises(ValueError) as je:
        jax_ap.build_controller(theirs)
    assert str(e.value) == str(je.value)


def test_replay_cli_is_exact_and_catches_a_tampered_record(tmp_path,
                                                           capsys):
    ladder = ap.build_ladder(parse_args(argv=ARGVS["geometry"]))
    ctl = ap.AutopilotController(ladder, (0.05, 0.6), 1, seed=9)
    for r, probes in enumerate(_stream(9, 25)):
        ctl.observe(r, probes)
    path = tmp_path / "run_1.json"
    path.write_text(json.dumps({"kind": "run_manifest",
                                "autopilot": ctl.record()}))
    assert replay.main([str(path), "-q"]) == 0
    assert replay.main([str(path)]) == 0
    assert "replay: EXACT" in capsys.readouterr().out
    bad = ctl.record()
    bad["trajectory"][3]["key"] = ap.key_str(ladder[-1])
    path.write_text(json.dumps({"extra": {"autopilot": bad}}))
    assert replay.main([str(path)]) == 1
    assert "DIVERGES" in capsys.readouterr().out
    path.write_text(json.dumps({"kind": "run_manifest"}))
    with pytest.raises(SystemExit):
        replay.main([str(path)])


# --- FedModel runs -----------------------------------------------------------


W, B, D, NUM_CLIENTS = 4, 2, 512, 16
BASE = dict(mode="sketch", error_type="virtual", local_momentum=0.0,
            virtual_momentum=0.9, num_workers=W, local_batch_size=B, seed=5,
            num_clients=NUM_CLIENTS, k=64, num_rows=5, num_cols=2048)


def _heavy_rounds(n, seed=5):
    """Power-law feature scales make the gradient heavy-tailed, so the
    sketch's recovery error sits far below the band across the walk."""
    rs = np.random.RandomState(seed)
    scale = (np.arange(1, D + 1) ** -1.5).astype(np.float32)
    return [{"client_ids": rs.choice(NUM_CLIENTS, W, replace=False)
             .astype(np.int32),
             "x": rs.randn(W, B, D).astype(np.float32) * scale,
             "y": rs.randn(W, B).astype(np.float32),
             "mask": np.ones((W, B), np.float32)} for _ in range(n)]


def _port_run(kw, rounds, ledger=""):
    cfg = Config(device="cpu", ledger=ledger, **dict(BASE, **kw))
    model = FedModel(None, torch.zeros(D),
                     lambda p, b, a: torch_linear_loss(p, b), cfg,
                     padded_batch_size=B)
    opt = FedOptimizer([{"lr": 0.25}], cfg, model=model)
    for batch in rounds:
        model(batch)
        opt.step()
    return model, opt


def _jax_loss(params, batch, cfg):
    pred = batch["x"] @ params["w"]
    n = jnp.maximum(jnp.sum(batch["mask"]), 1.0)
    loss = jnp.sum((pred - batch["y"]) ** 2 * batch["mask"]) / n
    return loss, (loss * 0.0 + 1.0,)


def _jax_run(kw, rounds, ledger=""):
    from commefficient_tpu.config import Config as JaxConfig
    cfg = JaxConfig(ledger=ledger, **dict(BASE, **kw))
    model = JaxFedModel(None, {"w": jnp.zeros((D,), jnp.float32)},
                        _jax_loss, cfg, padded_batch_size=B,
                        mesh=make_mesh([jax.devices()[0]]))
    opt = JaxFedOpt([{"lr": 0.25}], cfg, model=model)
    for batch in rounds:
        model({k: v if k == "client_ids" else jnp.asarray(v)
               for k, v in batch.items()})
        opt.step()
    return model


def _rounds_of(ledger):
    with open(ledger) as f:
        return [r for r in map(json.loads, f) if r["kind"] == "round"]


WALKS = {
    # f32 -> bf16 -> int8, every error far below LO
    "dtype": (dict(autopilot_band="0.1:0.6"), 8,
              ["bf16", "bf16", "int8"]),
    # on to the column-halving steps: the server re-seeds its tables
    "geometry": (dict(autopilot_band="0.15:0.8", autopilot_geometry=True),
                 12, ["bf16", "bf16", "int8"]),
}


@pytest.mark.parametrize("name", sorted(WALKS))
def test_autopilot_walk_is_the_references(tmp_path, name):
    kw, n, first = WALKS[name]
    kw = dict(kw, autopilot="on", probe_every=1, autopilot_cooldown=1)
    rounds = _heavy_rounds(n)
    model, _ = _port_run(kw, rounds, str(tmp_path / "ours.jsonl"))
    jmodel = _jax_run(kw, rounds, str(tmp_path / "theirs.jsonl"))
    model.finalize()
    jmodel.finalize()
    rec, jrec = model.autopilot_record(), jmodel.autopilot_record()
    lo, hi = ap.parse_band(kw["autopilot_band"])
    for t, jt in zip(rec["trajectory"], jrec["trajectory"]):
        assert t["key"] == jt["key"] and t["action"] == jt["action"]
        np.testing.assert_allclose(t["recovery_error"],
                                   jt["recovery_error"], rtol=RTOL,
                                   atol=ATOL)
        # no decision within rounding of the band's edges
        for err in (t["recovery_error"], jt["recovery_error"]):
            assert min(abs(err - lo), abs(err - hi)) >= MARGIN, err
    assert [t["key"].split("-")[0] for t in rec["trajectory"][:3]] == first
    assert rec["final"] == jrec["final"]
    if name == "geometry":
        assert ap.parse_key(rec["final"]).cols < BASE["num_cols"] // 2
    np.testing.assert_allclose(model.ps_weights.numpy(),
                               np.asarray(jmodel.ps_weights), rtol=RTOL,
                               atol=ATOL)
    ours, theirs = _rounds_of(str(tmp_path / "ours.jsonl")), \
        _rounds_of(str(tmp_path / "theirs.jsonl"))
    assert len(ours) == len(theirs) == n
    for r, j in zip(ours, theirs):
        assert sorted(r["counters"]) == sorted(j["counters"]), r["round"]
        assert sorted(r["spans"]) == sorted(j["spans"]), r["round"]
        assert sorted(r["probes"]) == sorted(j["probes"])
        for key in r["probes"]:
            np.testing.assert_allclose(r["probes"][key], j["probes"][key],
                                       rtol=RTOL, atol=ATOL, err_msg=key)
        assert (r["uplink_bytes"], r["downlink_bytes"]) == \
            (j["uplink_bytes"], j["downlink_bytes"])
    assert model._variants.counters()["misses"] <= \
        len({t["key"] for t in rec["trajectory"]} | {rec["initial"]})
    assert ap.replay_record(rec) == [t["key"] for t in rec["trajectory"]]


def test_autopilot_off_runs_the_base_round(tmp_path):
    """Off: the dispatched variant's config IS the model's args, one
    variant is built, and the autopilot's own knobs change nothing."""
    rounds = _heavy_rounds(3)
    model, _ = _port_run({}, rounds)
    var = model._variants.get(model._variant_key)
    assert var.cfg is model.args and model._autopilot is None
    assert model._variants.counters()["size"] == 1
    assert model.autopilot_record() is None
    other, _ = _port_run(dict(autopilot_cooldown=7, autopilot_cache_size=1,
                              autopilot_warm_ahead=0,
                              autopilot_band="0.2:0.3"), rounds)
    assert torch.equal(model.ps_weights, other.ps_weights)
    model.finalize()
    other.finalize()


@pytest.mark.parametrize("pin", ["int8-k64-r5-c2048-re9500",
                                 "f32-k64-r5-c512-re9500"])
def test_pinned_is_bit_equal_to_the_static_config(pin):
    key = ap.parse_key(pin)
    rounds = _heavy_rounds(5)
    static, _ = _port_run(dict(sketch_dtype=key.dtype, num_cols=key.cols,
                               probe_every=1), rounds)
    pinned, _ = _port_run(dict(autopilot="on", autopilot_band="0.05:0.6",
                               probe_every=1, autopilot_pin=pin), rounds)
    assert torch.equal(static.ps_weights, pinned.ps_weights)
    assert all(t["action"] == "pinned"
               for t in pinned.autopilot_record()["trajectory"])
    assert pinned.args.num_cols == key.cols
    static.finalize()
    pinned.finalize()


def test_switched_variant_is_bit_equal_to_a_fresh_build():
    model, opt = _port_run(dict(autopilot="on", autopilot_band="0.1:0.6",
                                probe_every=1, autopilot_cooldown=1),
                           _heavy_rounds(6))
    var = model._variants.get(model._variant_key)
    assert ap.key_str(var.key).startswith("int8")
    fresh = build_client_round(var.cfg,
                               lambda p, b: torch_linear_loss(p, b), B,
                               probes=True, probe_recovery=True)
    batch = _heavy_rounds(1, seed=11)[0]
    dev = {k: torch.from_numpy(v) for k, v in batch.items()
           if k != "client_ids"}
    ids = torch.from_numpy(batch["client_ids"].astype(np.int64))
    ps = model.ps_weights.clone()

    def run(fn):
        cs = ClientStates.init(var.cfg, NUM_CLIENTS, ps, torch.device("cpu"))
        return fn(ps, dev, cs, ids, 0.25, round_index=6)

    a, b = run(var.round_probed), run(fresh)
    assert torch.equal(a.aggregated, b.aggregated)
    assert a.probes.keys() == b.probes.keys()
    for k in a.probes:
        assert torch.equal(a.probes[k], b.probes[k]), k
    for x, y in zip(a.metrics, b.metrics):
        assert torch.equal(x, y)
    # the server round the variant built is a fresh build's too
    assert var.server_fn is not None
    model.finalize()


@pytest.mark.parametrize("warm", [1, 0])
def test_warm_ahead_builds_only_decided_points(tmp_path, warm):
    ledger = str(tmp_path / "w.jsonl")
    model, _ = _port_run(dict(autopilot="on", autopilot_band="0.1:0.6",
                              probe_every=1, autopilot_cooldown=1,
                              autopilot_warm_ahead=warm), _heavy_rounds(4),
                         ledger)
    model.finalize()
    rec = model.autopilot_record()
    visited = {t["key"] for t in rec["trajectory"]} | {rec["initial"]}
    assert {ap.key_str(k) for k in model._variants.keys()} == visited
    assert model._variants.counters()["misses"] == len(visited)
    rounds = _rounds_of(ledger)
    warmed = [r["round"] for r in rounds if "autopilot_warm" in r["spans"]]
    moves = [r["round"] for r in rounds
             if r["counters"].get("autopilot_moves")]
    assert moves == [0, 2]
    assert warmed == (moves if warm else [])
    # each flavor of each visited point is stamped once: probe_every 1
    # dispatches the probed client round only, and the server round
    programs = {}
    for r in rounds:
        for k, v in r["counters"].items():
            if k.startswith("vcompile_programs:"):
                key = k.split(":", 1)[1]
                programs[key] = programs.get(key, 0) + v
    assert programs == {k: 2 for k in visited}
    # a stand-still band never builds a second point
    still, _ = _port_run(dict(autopilot="on", autopilot_band="0.0:0.6",
                              probe_every=1), _heavy_rounds(3))
    assert still._variants.counters() == {"hits": 6, "misses": 1,
                                          "evictions": 0, "size": 1}
    still.finalize()


# --- the knob-mutation rule --------------------------------------------------


_KNOBS = {"sketch_dtype", "num_rows", "num_cols", "approx_recall"}
_CONFIG_RECEIVERS = {"cfg", "args", "config"}


WAIVER = "# audit: allow(knob-mutation)"


def _knob_writes(src):
    """Stores of a compression knob (``.k`` only on config-shaped
    receivers) and ``replace(...)`` calls passing knob keywords, but
    on a line carrying the reference's waiver comment: the
    reference's ``knob-mutation`` lint rule."""
    lines = src.splitlines()

    def recv(v):
        if isinstance(v, ast.Name):
            return v.id
        if isinstance(v, ast.Attribute) and isinstance(v.value, ast.Name) \
                and v.value.id == "self":
            return v.attr
        return None

    hits = []
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Attribute) and (
                        t.attr in _KNOBS or (t.attr == "k" and recv(
                            t.value) in _CONFIG_RECEIVERS)) \
                        and WAIVER not in lines[t.lineno - 1]:
                    hits.append(t.lineno)
        elif isinstance(node, ast.Call):
            f = node.func
            name = (f.attr if isinstance(f, ast.Attribute)
                    else f.id if isinstance(f, ast.Name) else None)
            if name == "replace" and any(kw.arg in _KNOBS | {"k"}
                                         for kw in node.keywords) \
                    and WAIVER not in lines[node.lineno - 1]:
                hits.append(node.lineno)
    return hits


def test_knob_mutation_scan_rejects_direct_writes():
    src = ("cfg.k = 3\n"
           "self.args.num_rows = 2\n"
           "x.sketch_dtype = 'int8'\n"
           "out = cfg.replace(k=4, num_cols=64)\n"
           "loop.k = 1\n"
           "s = s.replace(':', '-')\n"
           "c = dataclasses.replace(c, approx_recall=0.5)\n"
           f"args.k = 10  {WAIVER}\n")
    assert _knob_writes(src) == [1, 2, 3, 4, 7]


def test_apply_knobs_is_the_only_knob_write_in_the_port():
    pkg = os.path.join(ROOT, "commefficient_tpu_torch")
    hits = []
    for dirpath, _, files in os.walk(pkg):
        rel = os.path.relpath(dirpath, pkg)
        if rel.split(os.sep)[0] == "autopilot":
            continue
        for name in files:
            if not name.endswith(".py") or (rel == "." and
                                             name == "config.py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                hits += [(os.path.relpath(path, pkg), line)
                         for line in _knob_writes(f.read())]
    assert hits == []


def test_dataclass_replace_keeps_runtime_fields():
    cfg = parse_args(argv=ARGVS["f32"])
    cfg.grad_size = 777
    moved = ap.apply_knobs(cfg, ap.build_ladder(cfg)[-1])
    assert moved.grad_size == 777 and moved is not cfg
    assert dataclasses.replace(cfg).grad_size == 777
