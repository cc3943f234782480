"""Training targets: max-IoU assignment, random sampling, RPN targets and
losses, and sparse NOC targets (``monorun_tpu/targets`` in PyTorch)."""
