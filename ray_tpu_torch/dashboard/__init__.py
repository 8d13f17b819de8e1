"""The node agent the node manager hosts (``agent.py``). The dashboard head
(``ray_tpu/dashboard/head.py``) is not ported yet."""
