"""Classifier family registry.

The counterpart of `repro.families`: `FAMILIES` maps the registry key
("tree", "mlp") to the family object, and the engine layers resolve a
family through the three lookups below instead of importing family modules.
"""
from __future__ import annotations

from repro_torch.families import printed_mlp, tree
from repro_torch.families.base import ClassifierFamily

FAMILIES: dict[str, ClassifierFamily] = {
    tree.FAMILY.name: tree.FAMILY,
    printed_mlp.FAMILY.name: printed_mlp.FAMILY,
}


def get_family(name: str) -> ClassifierFamily:
    """Registry-key lookup ("tree" / "mlp")."""
    try:
        return FAMILIES[name]
    except KeyError:
        raise ValueError(f"unknown classifier family {name!r}; "
                         f"known: {sorted(FAMILIES)}") from None


def family_of(problem) -> ClassifierFamily:
    """The family owning a problem object."""
    for fam in FAMILIES.values():
        if fam.owns(problem):
            return fam
    raise TypeError(f"no registered classifier family owns "
                    f"{type(problem).__name__}")


def family_of_payload(payload: dict) -> ClassifierFamily:
    """The family of a pareto.json payload (no tag: the tree family)."""
    return get_family(payload.get("family", "tree"))


__all__ = ["ClassifierFamily", "FAMILIES", "get_family", "family_of",
           "family_of_payload", "tree", "printed_mlp"]
