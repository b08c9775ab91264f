"""`python -m moca_tpu_torch.cli`: the MoCA-Video CLI (cli/main.py)."""

from moca_tpu_torch.cli.main import _entry

if __name__ == "__main__":
    _entry()
