"""`python -m lrf_tpu_torch`: the command-line interface of `lrf_tpu_torch.cli`."""

from lrf_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
