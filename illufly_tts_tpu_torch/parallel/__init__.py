# -*- coding: utf-8 -*-
"""Device meshes and data parallelism (``mesh.py``)."""
