"""Experimental APIs of the port's runtime: cluster pub/sub (``pubsub``)."""
