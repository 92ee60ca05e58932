"""Graph-skeleton units (counterpart of ``veles_tpu/plumbing.py``)."""

from __future__ import annotations

from .units import Unit


class StartPoint(Unit):
    """Workflow entry node."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "Start")
        super().__init__(workflow, **kwargs)


class EndPoint(Unit):
    """Workflow exit node: running it finishes the workflow."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "End")
        super().__init__(workflow, **kwargs)

    def run(self) -> None:
        self.workflow.on_workflow_finished()


class Repeater(Unit):
    """Loop head: ignores its gate so the cycle's back edge can fire it
    again."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "Repeater")
        kwargs.setdefault("ignores_gate", True)
        super().__init__(workflow, **kwargs)
