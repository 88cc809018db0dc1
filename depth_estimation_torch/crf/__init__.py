"""Mean-field dense-CRF core: compatibilities, guides, inference."""
