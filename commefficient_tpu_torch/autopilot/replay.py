"""Bit-exact controller replay from a run-registry manifest.

    python -m commefficient_tpu_torch.autopilot.replay runs/manifests/run_*.json

Port of ``commefficient_tpu/autopilot/replay.py``. Loads the manifest's
recorded autopilot block (band, cooldown, ladder, observation
trajectory), re-runs the observations through a FRESH controller
(autopilot/controller.py replay_record — no model, no torch), and
verifies the replayed knob sequence equals the recorded one
entry-for-entry. Exit 0 on exact match, 1 on divergence;
tests/test_torch_autopilot.py goes through here, so the CLI is the
contract.
"""

from __future__ import annotations

import argparse
import json
import sys

from commefficient_tpu_torch.autopilot.controller import replay_record


def load_autopilot_record(manifest_path: str) -> dict:
    with open(manifest_path) as f:
        manifest = json.load(f)
    rec = (manifest.get("autopilot")
           or manifest.get("extra", {}).get("autopilot"))
    if not rec:
        raise SystemExit(
            f"{manifest_path}: no autopilot record in manifest "
            "(was the run launched with --autopilot on?)")
    return rec


def verify(rec: dict, verbose: bool = True) -> bool:
    recorded = [e["key"] for e in rec.get("trajectory", [])]
    replayed = replay_record(rec)
    ok = replayed == recorded
    if verbose:
        lo, hi = rec["band"]
        print(f"band {lo}:{hi}  cooldown {rec['cooldown']}  "
              f"ladder {' > '.join(rec['ladder'])}")
        last = None
        for e, rk in zip(rec.get("trajectory", []), replayed):
            mark = "" if rk == e["key"] else "  <-- DIVERGES"
            if e["key"] != last or mark:
                err = e.get("recovery_error")
                err_s = "-" if err is None else f"{err:.4f}"
                print(f"  round {e['round']:>4}  err {err_s:>8}  "
                      f"{e['action']:<8} {e['key']}{mark}")
            last = e["key"]
        print(f"replay: {'EXACT' if ok else 'DIVERGED'} "
              f"({len(recorded)} observations, "
              f"final {rec.get('final', '?')})")
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="replay + verify an autopilot trajectory from a "
                    "run-registry manifest")
    p.add_argument("manifest", help="runs/manifests/run_*.json")
    p.add_argument("-q", "--quiet", action="store_true")
    args = p.parse_args(argv)
    rec = load_autopilot_record(args.manifest)
    return 0 if verify(rec, verbose=not args.quiet) else 1


if __name__ == "__main__":
    sys.exit(main())
