"""Analytic cost terms of one model step (the profiles' inputs)."""
