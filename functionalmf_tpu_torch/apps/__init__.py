"""Applications of the port, each a counterpart of one in
functionalmf_tpu/apps/."""
