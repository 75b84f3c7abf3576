"""Roofline terms of the dry run on the H100 (counterpart of
`repro.roofline`): the card's peaks (`h100`) and the counted step's
record turned into compute, memory and collective terms (`analysis`)."""
