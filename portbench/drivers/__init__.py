"""General drivers of traffic mixes; a mix (`traffic/<name>.json`) names one."""
