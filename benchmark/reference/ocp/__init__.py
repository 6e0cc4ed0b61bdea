"""Stagewise transcription."""

from .transcribe import Transcription  # noqa: F401
