"""The calibration trainers (JAX ``trainers/``): phase->height,
volume->force, the colored- and black-TLC temperature models and the
thermal pretest, each on one device (the card unless ``device`` names
another)."""
