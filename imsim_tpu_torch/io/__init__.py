"""File input: the FITS reader (the writers come with the visit runner,
ROADMAP A6)."""
