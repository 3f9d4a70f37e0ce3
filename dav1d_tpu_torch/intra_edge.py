"""Intra-edge availability tree.

Static partition-topology DAG giving, for each node of the superblock
partition tree, which neighbouring edges (top-right / bottom-left) are
available per chroma layout (reference src/intra_edge.c:28-199).
"""

from __future__ import annotations

from .levels import BlockLevel

EDGE_I444_TOP_HAS_RIGHT = 1 << 0
EDGE_I422_TOP_HAS_RIGHT = 1 << 1
EDGE_I420_TOP_HAS_RIGHT = 1 << 2
EDGE_I444_LEFT_HAS_BOTTOM = 1 << 3
EDGE_I422_LEFT_HAS_BOTTOM = 1 << 4
EDGE_I420_LEFT_HAS_BOTTOM = 1 << 5
EDGE_ALL_TOP_HAS_RIGHT = (
    EDGE_I444_TOP_HAS_RIGHT | EDGE_I422_TOP_HAS_RIGHT | EDGE_I420_TOP_HAS_RIGHT)
EDGE_ALL_LEFT_HAS_BOTTOM = (
    EDGE_I444_LEFT_HAS_BOTTOM | EDGE_I422_LEFT_HAS_BOTTOM
    | EDGE_I420_LEFT_HAS_BOTTOM)
EDGE_ALL_TR_AND_BL = EDGE_ALL_TOP_HAS_RIGHT | EDGE_ALL_LEFT_HAS_BOTTOM


class EdgeNode:
    __slots__ = ("o", "h", "v", "h4", "v4", "split")

    def __init__(self):
        self.o = 0
        self.h = [0, 0]
        self.v = [0, 0]
        self.h4 = 0  # branches only
        self.v4 = 0
        self.split = []  # children (EdgeNode) for branches, flags for tips


def _init_edges(node: EdgeNode, bl: int, edge_flags: int, is_tip: bool) -> None:
    node.o = edge_flags
    node.h[0] = edge_flags | EDGE_ALL_LEFT_HAS_BOTTOM
    node.v[0] = edge_flags | EDGE_ALL_TOP_HAS_RIGHT
    if is_tip:
        node.h[1] = edge_flags & (EDGE_ALL_LEFT_HAS_BOTTOM
                                  | EDGE_I420_TOP_HAS_RIGHT)
        node.v[1] = edge_flags & (EDGE_ALL_TOP_HAS_RIGHT
                                  | EDGE_I420_LEFT_HAS_BOTTOM
                                  | EDGE_I422_LEFT_HAS_BOTTOM)
        node.split = [
            (edge_flags & EDGE_ALL_TOP_HAS_RIGHT) | EDGE_I422_LEFT_HAS_BOTTOM,
            edge_flags | EDGE_I444_TOP_HAS_RIGHT,
            edge_flags & (EDGE_I420_TOP_HAS_RIGHT | EDGE_I420_LEFT_HAS_BOTTOM
                          | EDGE_I422_LEFT_HAS_BOTTOM),
        ]
    else:
        node.h[1] = edge_flags & EDGE_ALL_LEFT_HAS_BOTTOM
        node.v[1] = edge_flags & EDGE_ALL_TOP_HAS_RIGHT
        node.h4 = EDGE_ALL_LEFT_HAS_BOTTOM
        node.v4 = EDGE_ALL_TOP_HAS_RIGHT
        if bl == BlockLevel.BL_16X16:
            node.h4 |= edge_flags & EDGE_I420_TOP_HAS_RIGHT
            node.v4 |= edge_flags & (EDGE_I420_LEFT_HAS_BOTTOM
                                     | EDGE_I422_LEFT_HAS_BOTTOM)


def _init_mode_node(bl: int, top_has_right: bool,
                    left_has_bottom: bool) -> EdgeNode:
    node = EdgeNode()
    _init_edges(node, bl,
                (EDGE_ALL_TOP_HAS_RIGHT if top_has_right else 0)
                | (EDGE_ALL_LEFT_HAS_BOTTOM if left_has_bottom else 0),
                is_tip=False)
    children = []
    for n in range(4):
        thr = not (n == 3 or (n == 1 and not top_has_right))
        lhb = n == 0 or (n == 2 and left_has_bottom)
        if bl == BlockLevel.BL_16X16:
            tip = EdgeNode()
            _init_edges(tip, bl + 1,
                        (EDGE_ALL_TOP_HAS_RIGHT if thr else 0)
                        | (EDGE_ALL_LEFT_HAS_BOTTOM if lhb else 0),
                        is_tip=True)
            children.append(tip)
        else:
            children.append(_init_mode_node(bl + 1, thr, lhb))
    node.split = children
    return node


# tree roots per superblock size: [0] = 128x128, [1] = 64x64
INTRA_EDGE_TREE = (
    _init_mode_node(BlockLevel.BL_128X128, True, False),
    _init_mode_node(BlockLevel.BL_64X64, True, False),
)
