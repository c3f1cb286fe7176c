"""Standalone torch demos: ``mls_mpm88`` and ``mls_mpm88_explained``."""
