"""PyTorch/CUDA port of the Hydra reproduction (JAX reference: ``repro``).

Mirrors the JAX package's layout (``configs/ core/ models/ kernels/
serving/ launch/``) so each module's counterpart is easy to find.  The
port imports torch, numpy and the standard library only — never JAX and
nothing of ``repro`` — and its entry points run on the CUDA device unless
the caller passes ``device="cpu"`` (see ``device.py``).
"""
