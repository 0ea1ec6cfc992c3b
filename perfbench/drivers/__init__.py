"""The drivers of the traffic mixes, one module a kind of mix; a mix's
`driver` key names its module."""
