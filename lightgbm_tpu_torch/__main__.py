"""`python -m lightgbm_tpu_torch` — the CLI front end (src/main.cpp analog)."""
from .cli import main

raise SystemExit(main())
