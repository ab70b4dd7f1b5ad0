"""PIQUE in PyTorch: the session main path on an NVIDIA H100.

A second package beside the JAX reference ``repro``.  It mirrors that
package's layout (``core/``, ``data/``, ``kernels/``, ``launch/``) so each
module's counterpart is easy to find, imports ``torch`` and ``numpy`` only,
and runs its Eq. 11 scoring through hand-written CUDA kernels
(``kernels/enrich_score``) when its tensors live on the card.

Entry points take an explicit ``device``: ``None`` means ``"cuda"``, and a
missing GPU raises instead of falling back (``repro_torch.device``).
"""
