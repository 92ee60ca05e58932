"""Shared mutable booleans and cross-object attribute aliasing
(counterpart of ``veles_tpu/mutable.py``; framework-agnostic Python).

``Bool`` is a mutable flag shared by reference between units: gate
expressions like ``~decision.complete & loader.epoch_ended`` build
derived Bools that re-read their operands whenever they are evaluated.
``LinkableAttribute`` makes ``a.attr`` a live pointer to ``b.attr``.
Derived Bools store an operator tree of plain objects, so they pickle
and deepcopy naturally.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple


class Bool:
    """Mutable shared boolean with a lazy operator algebra."""

    __slots__ = ("_value", "_op", "_operands", "on_true")

    def __init__(self, value: bool = False) -> None:
        self._value = bool(value)
        self._op: Optional[str] = None
        self._operands: Tuple["Bool", ...] = ()
        #: optional callback fired by ``<<=`` when the flag becomes True
        self.on_true: Optional[Callable[[], None]] = None

    @classmethod
    def _derived(cls, op: str, *operands: "Bool") -> "Bool":
        b = cls()
        b._op = op
        b._operands = operands
        return b

    def __bool__(self) -> bool:
        if self._op is None:
            return self._value
        vals = [bool(o) for o in self._operands]
        if self._op == "not":
            return not vals[0]
        if self._op == "and":
            return all(vals)
        if self._op == "or":
            return any(vals)
        if self._op == "xor":
            return vals[0] != vals[1]
        raise AssertionError(self._op)

    def __ilshift__(self, value: Any) -> "Bool":
        """``flag <<= True``: in-place assignment that keeps the object's
        identity, so every holder of the reference sees the change."""
        if self._op is not None:
            raise ValueError("cannot assign to a derived Bool expression")
        self._value = bool(value)
        if self._value and self.on_true is not None:
            self.on_true()
        return self

    def __invert__(self) -> "Bool":
        return Bool._derived("not", self)

    def __and__(self, other: "Bool") -> "Bool":
        return Bool._derived("and", self, _coerce(other))

    def __or__(self, other: "Bool") -> "Bool":
        return Bool._derived("or", self, _coerce(other))

    def __xor__(self, other: "Bool") -> "Bool":
        return Bool._derived("xor", self, _coerce(other))

    __rand__ = __and__
    __ror__ = __or__
    __rxor__ = __xor__

    def __repr__(self) -> str:
        if self._op is None:
            return "<Bool %s at 0x%x>" % (self._value, id(self))
        return "<Bool %s(%s)>" % (self._op, ", ".join(map(repr,
                                                          self._operands)))


def _coerce(v: Any) -> Bool:
    return v if isinstance(v, Bool) else Bool(bool(v))


_MISSING = object()


class LinkableAttribute:
    """Descriptor making ``owner.attr`` an alias of ``(target, attr)``.
    Installed on the class lazily; per-instance pointers live in
    ``instance.__linked__``. A class-level default is kept for unlinked
    sibling instances."""

    def __init__(self, name: str, default: Any = _MISSING) -> None:
        self.name = name
        self.default = default

    def __get__(self, obj: Any, objtype: Any = None) -> Any:
        if obj is None:
            return self
        links = obj.__dict__.get("__linked__", {})
        if self.name in links:
            target, attr = links[self.name]
            return getattr(target, attr)
        if self.name in obj.__dict__:
            return obj.__dict__[self.name]
        if self.default is not _MISSING:
            return self.default
        raise AttributeError(self.name)

    def __set__(self, obj: Any, value: Any) -> None:
        links = obj.__dict__.setdefault("__linked__", {})
        if self.name in links:
            target, attr = links[self.name]
            setattr(target, attr, value)
        else:
            obj.__dict__[self.name] = value

    @staticmethod
    def link(dst: Any, dst_attr: str, src: Any, src_attr: str,
             two_way: bool = False) -> None:
        """Make ``dst.dst_attr`` an alias of ``src.src_attr``. The alias
        is a live pointer, so writes through ``dst`` already reach
        ``src``: ``two_way`` is accepted for API parity and changes
        nothing."""
        cls = type(dst)
        desc = cls.__dict__.get(dst_attr)
        if not isinstance(desc, LinkableAttribute):
            prev = getattr(cls, dst_attr, _MISSING)
            if isinstance(prev, LinkableAttribute):
                prev = _MISSING
            setattr(cls, dst_attr, LinkableAttribute(dst_attr, prev))
        dst.__dict__.pop(dst_attr, None)
        links = dst.__dict__.setdefault("__linked__", {})
        links[dst_attr] = (src, src_attr)

    @staticmethod
    def unlink(obj: Any, attr: str) -> None:
        """Remove a pointer: the attribute keeps its current value as
        plain instance storage."""
        links = obj.__dict__.get("__linked__", {})
        if attr in links:
            value = getattr(obj, attr)
            del links[attr]
            obj.__dict__[attr] = value


def link(dst: Any, dst_attr: str, src: Any, src_attr: str = None,
         two_way: bool = False) -> None:
    LinkableAttribute.link(dst, dst_attr, src, src_attr or dst_attr, two_way)
