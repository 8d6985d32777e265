"""Call-count task wrappers (host side).

Counterpart of ``depthrenderer_tpu/tasks.py`` (reference
``DepthRenderer/utils.py:217-342``): delay a side effect by N calls, run it
once, or run it every Nth call. The batch farm gates its PNG snapshots with
:class:`RecurringTask`.
"""

from __future__ import annotations


class Task:
    """A callable with a call count (reference ``utils.py:217-242``)."""

    def __init__(self, task):
        self.task = task
        self.call_count = 0

    def __call__(self, *args, **kwargs):
        return self.task(*args, **kwargs)

    def reset(self):
        """Clear the state of the task."""
        self.call_count = 0


class DelayedTask(Task):
    """Runs the task only after the first ``delay`` calls (reference
    ``utils.py:245-271``)."""

    def __init__(self, task, delay=0):
        super().__init__(task)
        self.delay = delay

    def __call__(self, *args, **kwargs):
        self.call_count += 1
        if self.call_count > self.delay:
            return super().__call__(*args, **kwargs)
        return None


class OneTimeTask(Task):
    """Runs the task once until :meth:`reset` (reference
    ``utils.py:274-303``)."""

    def __init__(self, task):
        super().__init__(task)
        self.is_done = False

    def __call__(self, *args, **kwargs):
        self.call_count += 1
        if not self.is_done:
            self.is_done = True
            return super().__call__(*args, **kwargs)
        return None

    def reset(self):
        super().reset()
        self.is_done = False


class RecurringTask(Task):
    """Runs the task on every ``frequency``-th call, the first call included
    (reference ``utils.py:306-342``)."""

    def __init__(self, task, frequency=1):
        super().__init__(task)
        if frequency < 1:
            raise ValueError(f"RecurringTask needs a frequency >= 1 (got "
                             f"{frequency}).")
        self.frequency = frequency

    def __call__(self, *args, **kwargs):
        result = None
        if self.call_count % self.frequency == 0:
            result = super().__call__(*args, **kwargs)
        self.call_count += 1
        return result
