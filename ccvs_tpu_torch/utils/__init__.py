"""Host-side utilities of the port: checkpoints, logging, preemption, video
reading."""
