"""One-off tools of the benchmark, run by hand on the card; the
benchmark's runs do not use them."""
