"""`python -m saev_tpu_torch.web`: serve the demo apps (backend.main)."""

from .backend import main

if __name__ == "__main__":
    raise SystemExit(main())
