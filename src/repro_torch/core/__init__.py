"""SimFreeze and its CKA probe (ports part of `repro.core`)."""
