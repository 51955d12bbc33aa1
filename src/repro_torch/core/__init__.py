"""Hetero-SplitEE core of the port: losses, the split-model adapters, Eq. (1)
aggregation, the client and server steps, Alg. 3 inference, the fused
train steps and the serve step."""
