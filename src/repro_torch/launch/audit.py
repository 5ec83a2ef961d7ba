"""Launcher for the analysis passes, the same entry point as
``python -m repro_torch.analysis``:

    PYTHONPATH=src python -m repro_torch.launch.audit --all-configs \
        --out /tmp/audit_report.json
"""
from repro_torch.analysis.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
