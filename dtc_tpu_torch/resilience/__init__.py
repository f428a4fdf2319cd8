"""Resilience: retry and position-preserving stream healing, the hung-step
watchdog, the anomaly guard's ladder and the typed failures."""
