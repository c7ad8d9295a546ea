"""The benchmark's plain reference: PyTorch and NumPy only.

It imports neither JAX nor the JAX package nor anything of the port, and
takes nothing the port has made: it reads the raw weights file itself and
works out the letterbox, the net, NMS, the DB decode, the grouping and the
mask refinement (``pipeline.py``), and the DB training step (``train.py``)
again from the benchmark's inputs.  The model, the grouping and the host
refinement are frozen copies of the port's plain code (each file says
which); ``dbdecode.py``, ``pipeline.py``, ``losses.py`` and ``train.py``
are the reference's own.
"""
