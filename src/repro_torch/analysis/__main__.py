"""CLI for the analysis layer: ``python -m repro_torch.analysis``.

Port of ``python -m repro.analysis``. The default run: the AST rule pass,
then the census of every entry point checked against the port's
``analysis/budgets.json`` and the structural rules; on the card (the
default device, as for every entry point of the port) the profiler census
of the same entries besides, its kernel launches held to the CPU census's
kernel calls. Exit code 0 only if everything holds.

    python -m repro_torch.analysis --device cpu      # AST pass + CPU census
    python -m repro_torch.analysis                   # ... + the card census
    python -m repro_torch.analysis --ast-only        # no entry point runs
    python -m repro_torch.analysis --census-only
    python -m repro_torch.analysis --update-budgets  # regenerate the budgets
    python -m repro_torch.analysis --budgets PATH    # another budget file

Without ``--device`` and without a GPU it raises, as the port's entry
points do.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis import astlint, census
from repro_torch.devices import resolve_device


def _repo_root() -> str:
    """Three levels above src/repro_torch/analysis/."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__)
    ap.add_argument("--budgets", default=None,
                    help="budget file (default: src/repro_torch/analysis/"
                         f"{census.BUDGETS_BASENAME})")
    ap.add_argument("--update-budgets", action="store_true",
                    help="re-census every entry point and rewrite the "
                         "budget file (waivers kept); review the diff")
    ap.add_argument("--ast-only", action="store_true",
                    help="run only the AST rule pass (no entry point runs)")
    ap.add_argument("--census-only", action="store_true",
                    help="run only the census check")
    ap.add_argument("--device", default=None,
                    help="cpu, or the GPU (the default): the card census "
                         "besides the CPU one")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    budgets_path = args.budgets or census.default_budgets_path()
    budgets = {}
    if os.path.exists(budgets_path):
        budgets = census.load_budgets(budgets_path)

    failed = False

    if not args.census_only:
        remaining, waived = astlint.run(
            _repo_root(), budgets.get("waivers", {}).get("ast", []))
        for v in waived:
            print(f"  waived: {v}")
        for v in remaining:
            print(f"FAIL: {v}", file=sys.stderr)
        print(f"ast pass: {len(remaining)} violation(s), "
              f"{len(waived)} waived")
        failed |= bool(remaining)

    if not args.ast_only:
        print("censusing entry points (one eager run each, on the CPU)…")
        results = census.collect()
        if args.update_budgets:
            path = census.update_budgets(results, budgets_path)
            print(f"wrote {len(results)} entry budgets to {path} — review "
                  "the diff before committing")
            # even a fresh budget must satisfy the structural rules
            fails = census.structural_failures(results)
        else:
            if not budgets:
                print(f"FAIL: {budgets_path} missing — run with "
                      "--update-budgets to create it", file=sys.stderr)
                return 1
            fails = census.check(results, budgets)
        if device.type == "cuda":
            print("profiling each entry point on the card…")
            # in a fresh interpreter: in this process's profiler the
            # port's kernel events can be lost (census.collect_in_child)
            card = census.collect_in_child(device=device)
            for entry, got in sorted(card.items()):
                print(f"  {entry:16s} {json.dumps(got, sort_keys=True)}")
            fails += census.card_failures(results, card)
        for f in fails:
            print(f"FAIL: {f}", file=sys.stderr)
        print(f"census: {len(results)} entry points, "
              f"{len(fails)} failure(s)")
        failed |= bool(fails)

    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
