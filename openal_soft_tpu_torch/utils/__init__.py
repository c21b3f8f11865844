"""Offline tools: UHJ codecs, the HRTF compiler and the device lister."""
