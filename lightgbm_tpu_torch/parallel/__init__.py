"""The distributed tree learners (``learners.py``) and ``grow_tree_dp``."""
