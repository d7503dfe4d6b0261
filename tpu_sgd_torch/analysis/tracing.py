"""AST helpers shared by the lint rules (the framework-free part of
``tpu_sgd/analysis/tracing.py``): dotted names, parent maps and
enclosing-node lookups.

The JAX package's module also decides which functions JAX traces (the
``TracedIndex`` behind shape-trap and eager-in-loop).  That half has no
meaning in the port until those rules get torch counterparts (graph
capture per shape): it waits for ROADMAP A12 step 2.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional


def dotted_name(node: ast.AST) -> Optional[str]:
    """``torch.cuda.synchronize`` for a Name/Attribute chain, else
    None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def last_seg(name: Optional[str]) -> str:
    return name.rsplit(".", 1)[-1] if name else ""


def build_parents(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def enclosing(node: ast.AST, parents: Dict[ast.AST, ast.AST],
              kinds) -> Optional[ast.AST]:
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, kinds):
            return cur
        cur = parents.get(cur)
    return None
