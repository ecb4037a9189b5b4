"""Stand-alone tools of tps_torch (run with python -m tps_torch.tools.<name>)."""
