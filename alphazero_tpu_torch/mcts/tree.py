"""Tree constants shared by the search engines.

Counterpart of the constants of ``alphazero_tpu/mcts/tree.py``; the
batched tree itself comes with the port of the dense engine.
"""

UNVISITED = -1.0    # child-code sentinel: edge not expanded
INVALID_P = -1e30   # masked-prior sentinel for illegal actions
