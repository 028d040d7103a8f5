"""Serving preprocessing on the device."""
