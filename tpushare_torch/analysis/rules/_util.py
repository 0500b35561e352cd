"""Shared AST helpers for the rule families."""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def last_component(name: Optional[str]) -> str:
    return name.rsplit(".", 1)[-1] if name else ""


def is_self_attr(node: ast.AST) -> Optional[str]:
    """Dotted attribute path rooted at ``self`` (``self.a.b`` ->
    ``"a.b"``), else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name) and node.id == "self" and parts:
        return ".".join(reversed(parts))
    return None


def walk_no_nested_functions(node: ast.AST) -> Iterator[ast.AST]:
    """ast.walk that does NOT descend into nested function/class
    definitions (their scope is analyzed separately)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        yield child
        if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(child))


def assigned_names(target: ast.AST) -> Iterator[str]:
    """Plain names bound by an assignment target (tuples unpacked)."""
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from assigned_names(elt)
    elif isinstance(target, ast.Starred):
        yield from assigned_names(target.value)
