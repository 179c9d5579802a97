"""repro_torch.analysis — the analysis layer over the port (port of
``repro.analysis``, DESIGN.md §11).

The paper's claims survive in this repo as invariants (the ADC-less
frontend step holds no convolution and one product, a fleet step batches
its kernels whatever the fleet size, the int8 step sums one s8 x s8
product in int32, physics single-sourced in ``core/``). This package turns
them into machinery every change runs:

``census``   the op census of every public entry point: a dispatch-mode
             census on the CPU, checked against ``analysis/budgets.json``,
             and a profiler census of the kernels' launches on the card
``astlint``  the repo's AST rules over ``src/repro_torch`` (physics-constant
             anti-fork, the single clock, no host RNG, frozen configs,
             import-graph orphans, no floating-point product in an int8
             path)

The reference's third module, ``tracecheck`` (it names the argument that
forced a jit retrace, through ``jax._src.pjit``), has no counterpart: the
port compiles nothing per call. It runs eagerly and builds its CUDA
libraries once, at first use, keyed by a hash of their sources.

CLI: ``python -m repro_torch.analysis [--device cpu]`` runs the AST pass
and the census check; ``--update-budgets`` regenerates the budget file.
"""
from repro_torch.analysis import astlint, census

__all__ = ["astlint", "census"]
