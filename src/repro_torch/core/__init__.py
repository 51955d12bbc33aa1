"""Hetero-SplitEE core of the port: losses, Eq. (1) participation counts,
the fused train steps and the serve step."""
