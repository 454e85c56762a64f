"""Compatibility shims for optional third-party dependencies (twin of
the reference's ``_compat``).

When an optional package is missing, a minimal fallback with the same
surface is installed instead, so a test suite that uses it collects and
runs on a bare image.  ``hypothesis_fallback`` is a copy of the
reference's: it is pure Python and NumPy and imports nothing of either
package.
"""
