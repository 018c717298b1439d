"""``python -m repro_torch.obs trace.json [--min-coverage 0.95]``: validates a
Chrome trace written by ``launch.serve --trace`` (schema and span coverage)."""
from repro_torch.obs.trace import main

if __name__ == "__main__":
    main()
