"""Typed failures of the resilience code: the port's copy of the JAX
package's ``resilience/errors.py`` for what the port raises. The trainer
and the data stream branch on these types instead of on messages."""

from __future__ import annotations


class ResilienceError(RuntimeError):
    """Base class for failures raised by the resilience code itself."""


class DataStreamError(ResilienceError):
    """The input stream is dead beyond repair: its retries are exhausted.
    Carries the last underlying exception as ``__cause__``."""


class AnomalyAbort(ResilienceError):
    """The anomaly guard's ladder is exhausted (``max_rollbacks`` spent and
    the loss still unhealthy): a clean abort, so a supervisor can restart
    from the last verified checkpoint."""


class ChaosTargetError(ResilienceError):
    """A chaos fault fired but its configured victim does not exist at fire
    time (``fleet_target_replica`` names a replica that was never spawned
    or is already dead). The replica set changes under spawn and retire,
    so the target is judged when the fault fires, and a stale one raises
    instead of skipping the injection: a drill that silently skips it
    would pass vacuously."""


class ChaosInjectedError(ConnectionError):
    """A deterministic fault the chaos harness raises into the data plane.

    It subclasses ``ConnectionError`` on purpose: the stream's retry
    wrapper treats it exactly as a real transient network failure, so the
    drill runs the production healing path."""
