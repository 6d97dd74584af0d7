"""StoCFL core: Ψ extractor, clustering, bi-level update, aggregators."""
