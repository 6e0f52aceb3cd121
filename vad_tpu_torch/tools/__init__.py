"""The port's measuring probes, run as ``python -m vad_tpu_torch.tools.<name>``."""
