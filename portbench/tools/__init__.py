"""Tools that fixed the benchmark's sizes; the benchmark's runs use none."""
