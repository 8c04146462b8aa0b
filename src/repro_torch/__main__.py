"""``python -m repro_torch`` — the CLI front door (see `repro_torch.api.cli`)."""
from repro_torch.api.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
