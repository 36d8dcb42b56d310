"""Shared ASCII board rendering for the port's play and analyze CLIs.

A copy of ``examples/boardio.py`` (the port imports nothing of the JAX
package's tree): the same glyphs, orientation and footer."""


def render(board, flip_rows=False):
    """Render a 2-D board of {-1, 0, +1} as X / O / '.' with row labels
    and a column footer. ``flip_rows=True`` draws row 0 at the bottom
    (gravity games like connect-four)."""
    import numpy as np

    chars = {1: "X", -1: "O", 0: "."}
    b = np.asarray(board)
    h, w = b.shape
    order = range(h - 1, -1, -1) if flip_rows else range(h)
    rows = [
        f"{r:2d} |" + " ".join(chars[int(v)] for v in b[r]) + "|"
        for r in order
    ]
    return "\n".join(rows) + "\n    " + " ".join(str(c % 10) for c in range(w))
