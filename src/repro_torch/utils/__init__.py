"""Tree helpers (``utils/tree.py``). The reference's ``key_iter`` and
``fold_in_str`` (``utils/prng.py``) derive JAX PRNG keys: the port draws
from ``torch.Generator``s and has no such keys, so they are not ported."""
from repro_torch.utils.tree import tree_allclose, tree_bytes, tree_norm, tree_size

__all__ = ["tree_size", "tree_bytes", "tree_allclose", "tree_norm"]
