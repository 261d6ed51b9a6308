"""Share of COMBINE's consensus alignments that ran on the card: a job's
pairs aligned by the card's Gotoh kernel (the count
`consensus.card_alignments` of the program's --profile record) over those
and the pairs the host aligner ran (`consensus.host_alignments`), in %,
averaged over the traced jobs.  Nothing to read where a job's record has
neither count, or counts no pair."""

UNIT = "%"


def read(trace):
    values = []
    for job in trace["stages"]:
        counts = job.get("counts", {})
        card = counts.get("consensus.card_alignments")
        host = counts.get("consensus.host_alignments")
        if card is None and host is None:
            return None
        total = (card or 0) + (host or 0)
        if not total:
            return None
        values.append(100.0 * (card or 0) / total)
    if not values:
        return None
    return sum(values) / len(values)
