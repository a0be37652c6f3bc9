"""Serving: the continuous-batching engine and its host-side bookkeeping."""
