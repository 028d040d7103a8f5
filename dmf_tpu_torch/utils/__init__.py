"""Run bookkeeping: metric logs, ``metrics.json`` and checkpoints."""
