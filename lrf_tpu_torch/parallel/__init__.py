"""Batched encode and decode of same-size images on one device."""
