"""The port's counterparts of the JAX package's `examples/` scripts, under
the same file names:

  * `compare_checkpoints`: N checkpoints scored on one val slice, written
    as the reference's depth_model_comparison_results.csv schema;
  * `synthetic_convergence`: UNet-256 trained 30 epochs on the synthetic
    corpus, validated on held-out samples;
  * `family_sweep`: every model family trained 10 epochs, first and last
    validation;
  * `family_step_bench`: each family's train step at full width on one
    device-resident batch;
  * `commands.sh`: the reference's run_*.sh surface on the port's CLIs.

Each runs as ``python -m audiodepth_tpu_torch.examples.<name>`` on
``--device`` (default ``cuda``; it raises without a card, and ``--device
cpu`` runs on the CPU). Each is a set of plain functions that return
their table, with a `main(argv)` that prints it. A failing family raises:
nothing is caught.
"""

from __future__ import annotations


def parse_overrides(specs) -> dict:
    """`--override SECTION.KEY=VALUE` strings → {dotted key: value}, with
    `cli.train`'s coercion."""
    from ..cli.train import _parse_override

    return dict(_parse_override(s) for s in specs or ())

