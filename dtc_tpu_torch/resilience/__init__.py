"""Retry and hung-step watchdog for the serving runtime."""
