"""The port's private copies of what it needs from ``ray_tpu/_private``."""
