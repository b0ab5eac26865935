"""Two-view proposals and the global line triangulator."""
