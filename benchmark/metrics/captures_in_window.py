"""Captures of the compiled frame and shadow atlas during the traced
window (their caches' misses): a configuration that moved, as a capacity
that grew or shrank."""


def read(data):
    return data.captures
