"""Stage-1 training CLI, the counterpart of `conductor_tpu/cli/train_m2snet.py`:
not ported yet.  Train with `conductor_tpu_torch.M2SNetTrainer` directly.

    python -m conductor_tpu_torch.cli.train_m2snet
"""

from __future__ import annotations


def main(argv: list[str] | None = None) -> None:
    raise NotImplementedError("the train_m2snet CLI is not ported yet; use M2SNetTrainer")


if __name__ == "__main__":
    main()
