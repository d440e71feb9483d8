"""ML sidecar: features, AR model fit, dataset formats, classification."""
