"""Export a checkpoint of the port to a reference-format ``.pth``.

Counterpart of tools/export_torch.py: the reference's run_stageN loaders
and offline eval scripts read ``{'model': state_dict, 'epoch': N}``
(utils.py:689-736), which is what this writes; a stage-3 combined
checkpoint (``model.*`` and ``classifier.*``) also carries the head as
``src_classifier``::

    python -m unite_torch.tools.export_torch \\
        runs/stage2/exp/checkpoint-best.pth exported.pth

The port's weights are in the torch layout already, so the JAX tool's
``--patch-size`` and ``--in-chans`` (which turn a flax kernel into a
Conv3d weight) have no counterpart here. It runs on the CPU.
"""

from __future__ import annotations

import argparse

from unite_torch.utils.torch_export import export_checkpoint


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("src", help="a checkpoint of the port (.pth)")
    ap.add_argument("dst", help="output .pth path")
    return ap


def main(argv=None) -> str:
    """Write the export and return the line printed. It moves tensors on
    the CPU and computes nothing."""
    a = parser().parse_args(argv)
    line = f"wrote {export_checkpoint(a.src, a.dst)}"
    print(line)
    return line


if __name__ == "__main__":
    main()
