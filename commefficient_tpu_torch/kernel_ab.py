"""A parent tree against this one on the card: one suite of kernels,
and the rounds that run them.

    python -m commefficient_tpu_torch.kernel_ab PARENT [--suite SUITE]
        [--skip_rounds] [--out DIR]

PARENT is a checkout of the parent commit (``git archive`` unpacked into
a directory that ``.gitignore`` lists). Each run is a process of its
own started from the root of its tree, in the order parent, change,
change, parent. Suites:

- ``attention`` (the default): that tree's ``chip_smoke.py``
  ``attention_phases`` (the three flash attention kernels checked
  against their plain versions, then timed at the GPT-2 round's shape
  and at T 1024 beside ``scaled_dot_product_attention``), then the three
  at f32 (4 x 12 heads x T 256 x hd 64); rounds:
  ``profile_round --model gpt2 --attn_impl flash --rounds 6`` and the
  same with ``--remat``, with the device time a round of the three
  kernels;
- ``selection``: that tree's ``chip_smoke.py`` phases ``kernel_phases``,
  ``sketch_quant_phase`` and ``gpt2_shape_phase`` (each checks its
  kernels against their plain versions before it times them), then,
  with that tree's ``chip_smoke.time_ms`` (L2 flushed before each
  launch): the take-mask on a tie-heavy input (64 levels over 2 000 003
  keys, k = 10^6: ~31 000 ties at T in every stretch of the vector, the
  ``edge_phases`` case), and the fp8 sketch-and-quantize at GPT-2's
  padded d (held byte-equal to quantizing the sketch kernel's table);
  rounds: ``profile_round --model gpt2 --rounds 6`` and ``--sketch_dtype
  int8 --rounds 8``, with the device time a round of the take-mask and
  the sketch-and-quantize.

Every run's JSON lines go to ``OUT/<kind>_<i>_<tree>.jsonl``; standard
output gets one summary line a run, then the card's name and power limit
as ``nvidia-smi`` reports them. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# run from the root of a tree; uses only what both trees have
_KERNELS = r'''
import inspect, json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from commefficient_tpu_torch import _build
from commefficient_tpu_torch.ops import quant
from commefficient_tpu_torch.ops import sketch_kernels as sk
from commefficient_tpu_torch.ops import topk_kernels as tk
from commefficient_tpu_torch.ops.sketch import CountSketch
from commefficient_tpu_torch.ops.topk import keys_of
_build.build_all()
dev = torch.device("cuda", 0)
l2 = sk.l2_read_rate(dev)
flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)


def call(fn, *args):  # l2_bps goes to the phases that take it
    return fn(*args[:len(inspect.signature(fn).parameters)])


rows = {r["name"]: r for r in call(cs.kernel_phases, dev, flush, l2)
        + call(cs.sketch_quant_phase, dev, flush, l2)}
gpt2 = call(cs.gpt2_shape_phase, dev, flush, l2)
torch.cuda.empty_cache()

gen = torch.Generator(device=dev).manual_seed(3)
sq = (torch.randint(0, 64, (2_000_003,), generator=gen, device=dev).float()
      / 64) ** 2
t, need = tk.threshold_key_plain(sq, 1_000_000)
mk = tk.take_mask_kernel(sq, t, need)
assert torch.equal(mk, tk.take_mask_plain(sq, t, need))
ties = int((keys_of(sq) == t).sum())
tie_ms = cs.time_ms(lambda: tk.take_mask_kernel(sq, t, need), 20, flush)
del sq, mk

s = CountSketch(d=cs.GPT2_D, c=cs.C, r=cs.R, seed=cs.SEED)
vp = torch.nn.functional.pad(
    torch.randn(cs.GPT2_D, generator=torch.Generator(device=dev)
                .manual_seed(2), device=dev), (0, s._padded_d - cs.GPT2_D))
rot = s.rotations_on(dev)
args = (vp, rot, cs.C, cs.R, s.sign_seed, s._one_mix_signs, "fp8")
kw = ({"signs": s.packed_signs_on(dev)} if "signs" in
      inspect.signature(sk.sketch_quant_kernel).parameters else {})
q, rm = sk.sketch_quant_kernel(*args, **kw)
qt, rmt = quant.quantize_local(sk.sketch_kernel(*args[:6]), "fp8")
assert torch.equal(q.view(torch.uint8), qt.view(torch.uint8))
assert torch.equal(rm, rmt)
fp8_ms = cs.time_ms(lambda: sk.sketch_quant_kernel(*args, **kw), 10, flush)

print(json.dumps({"summary": {
    "take_mask_ms": [rows["take_mask"]["ms"], gpt2["take_mask"]["ms"]],
    "take_mask_scan_ms": [rows["take_mask"].get("scan_ms"),
                          gpt2["take_mask"].get("scan_ms")],
    "tie_heavy_take_mask_ms": tie_ms, "tie_heavy_ties_at_T": ties,
    "sketch_quant_int8_ms": [rows["sketch_quant"]["ms"],
                             gpt2["sketch_quant"]["ms"]],
    "sketch_quant_fp8_ms": [rows["sketch_quant"]["fp8"]["ms"], fp8_ms],
    "unfused_int8_ms": [rows["sketch_quant"]["unfused_ms"],
                        gpt2["sketch_quant"]["unfused_ms"]],
    "search_ms": [rows["threshold_key"]["ms"],
                  gpt2["threshold_key"]["ms"]],
    "selection_ms": [rows["threshold_key"]["selection_ms"],
                     gpt2["threshold_key"]["selection_ms"]],
    "l2_read_bps": l2,
    "ptxas": {stem: cs.ptxas_report(_build.BUILD_LOGS.get(stem, ""))
              for stem in ("take_mask", "sketch")}}}), flush=True)
'''

_ATTENTION = r'''
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from commefficient_tpu_torch import _build
_build.build_all(["flash_attn"])
dev = torch.device("cuda", 0)
flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
rows = cs.attention_phases(dev, flush)
# the f32 instantiations (attention_phases checks them, times bf16 only)
from commefficient_tpu_torch.ops import attention_kernels as ak
q, k, v, do = cs.attn_inputs(dev, 4, 12, 256, 64, torch.float32, seed=320)
scale = 64 ** -0.5
op, mp, lp = ak.attn_fwd_plain(q, k, v, scale)
bwd = (q, k, v, mp, lp, do, (op * do).sum(-1).contiguous(), scale)
f32 = {"attn_fwd": lambda: ak.attn_fwd_kernel(q, k, v, scale),
       "attn_bwd_dkv": lambda: ak.attn_bwd_dkv_kernel(*bwd),
       "attn_bwd_dq": lambda: ak.attn_bwd_dq_kernel(*bwd)}
print(json.dumps({"summary": {
    r["name"]: {"ms": [r["ms"], r["t1024"]["ms"]],
                "f32_ms": cs.time_ms(f32[r["name"]], 10, flush),
                "bound_ms": [r["bound_ms"], r["t1024"]["bound_ms"]],
                "library_ms": [r["library_ms"], r["t1024"]["library_ms"]]}
    for r in rows}}), flush=True)
'''

_GPT2 = ["--model", "gpt2", "--rounds", "6", "--top", "400"]
# suite: (kernels script, rounds (kind, profile_round flags), the
# device-time rows of the kernels under test by name)
_SUITES = {
    "attention": (_ATTENTION,
                  (("gpt2_flash", _GPT2 + ["--attn_impl", "flash"]),
                   ("gpt2_flash_remat",
                    _GPT2 + ["--attn_impl", "flash", "--remat"])),
                  ("attn_",)),
    # the take-mask (in older trees also its three kernels cet_eq_count,
    # cet_eq_scan and cet_take_write) and the sketch-and-quantize
    "selection": (_KERNELS,
                  (("gpt2", _GPT2),
                   ("int8", ["--sketch_dtype", "int8", "--rounds", "8",
                             "--top", "400"])),
                  ("take_mask", "cet_eq_", "cet_take_write",
                   "sketch_quant")),
}


def _run(cmd, cwd: Path, log: Path) -> list:
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
    log.write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[:3]} in {cwd} exited {proc.returncode}; "
                           f"see {log}")
    return [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith("{")]


def _round_summary(lines, watch=_SUITES["selection"][2]) -> dict:
    by = {ln.get("phase"): ln for ln in lines}
    dev = by["device"]
    return {"busy_ms_per_round": dev["busy_ms_per_round"],
            "busy_share": dev["busy_share"],
            "wall_median_s": by["round_wall"]["median_s"],
            "peak_mem_GiB": by["round_wall"]["peak_mem_GiB"],
            "phases_s": [by["phases"][k]
                         for k in ("data_s", "client_s", "server_s")],
            "host_syncs": [by["host_syncs"]["client"],
                           by["host_syncs"]["server"]],
            "watched_ms_per_round": {
                e["name"]: e["ms_per_round"] for e in dev["top"]
                if any(w in e["name"] for w in watch)}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("parent", type=Path)
    ap.add_argument("--suite", choices=sorted(_SUITES), default="attention")
    ap.add_argument("--skip_rounds", action="store_true")
    ap.add_argument("--out", type=Path, default=Path("build/kernel_ab"))
    opts = ap.parse_args(argv)
    trees = {"parent": opts.parent.resolve(),
             "change": Path(__file__).resolve().parent.parent}
    opts.out.mkdir(parents=True, exist_ok=True)
    script, rounds, watch = _SUITES[opts.suite]
    order = ("parent", "change", "change", "parent")
    for i, tree in enumerate(order):
        lines = _run([sys.executable, "-c", script], trees[tree],
                     opts.out.resolve() / f"kernels_{i}_{tree}.jsonl")
        print(json.dumps({"run": i, "tree": tree, "kind": "kernels",
                          **lines[-1]["summary"]}), flush=True)
    if not opts.skip_rounds:
        for kind, args in rounds:
            for i, tree in enumerate(order):
                lines = _run([sys.executable, "-m",
                              "commefficient_tpu_torch.profile_round", *args],
                             trees[tree],
                             opts.out.resolve() / f"{kind}_{i}_{tree}.jsonl")
                print(json.dumps({"run": i, "tree": tree, "kind": kind,
                                  **_round_summary(lines, watch)}),
                      flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
