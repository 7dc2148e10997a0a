"""Host-side utilities (trajectory evaluation)."""
