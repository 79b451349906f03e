"""Host-side primitives (SM3)."""
