"""Minimal search console UI.

Role of `quickwit-ui` (the reference's React SPA served by the node): a
zero-dependency single-page console at `/ui` — query input, time range,
index picker, hit table, aggregation viewer, and a SQL tab driving
`POST /api/v1/_sql` — all against this node's own REST API from the
browser.
"""

UI_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>quickwit-tpu console</title>
<style>
  :root { --fg: #1a1f36; --muted: #667085; --line: #e4e7ec; --accent: #175cd3; }
  * { box-sizing: border-box; }
  body { font: 14px/1.45 system-ui, sans-serif; color: var(--fg); margin: 0; }
  header { padding: 14px 20px; border-bottom: 1px solid var(--line);
           display: flex; gap: 10px; align-items: center; }
  header h1 { font-size: 16px; margin: 0 14px 0 0; }
  main { padding: 16px 20px; }
  input, select, button { font: inherit; padding: 7px 10px;
    border: 1px solid var(--line); border-radius: 6px; }
  input#query { flex: 1; min-width: 240px; }
  button { background: var(--accent); color: #fff; border: none; cursor: pointer; }
  table { border-collapse: collapse; width: 100%; margin-top: 14px; }
  th, td { text-align: left; padding: 6px 10px; border-bottom: 1px solid var(--line);
           vertical-align: top; font-size: 13px; }
  th { color: var(--muted); font-weight: 600; }
  td pre { margin: 0; white-space: pre-wrap; word-break: break-all;
           font-size: 12px; max-height: 90px; overflow: auto; }
  #meta { color: var(--muted); margin-top: 10px; }
  #error { color: #b42318; margin-top: 10px; white-space: pre-wrap; }
  #aggs { margin-top: 14px; }
  #aggs pre { background: #f8fafc; border: 1px solid var(--line);
              border-radius: 6px; padding: 10px; font-size: 12px; overflow: auto; }
  nav { display: flex; gap: 4px; margin-right: 10px; }
  nav button { background: none; color: var(--muted); border: 1px solid
               transparent; padding: 6px 10px; }
  nav button.active { color: var(--accent); border-color: var(--line);
                      border-radius: 6px; background: #f8fafc; }
  #sqlbar { display: none; padding: 14px 20px; border-bottom: 1px solid
            var(--line); }
  #sqlbar textarea { width: 100%; font: 13px/1.4 ui-monospace, monospace;
    padding: 8px 10px; border: 1px solid var(--line); border-radius: 6px;
    min-height: 64px; resize: vertical; }
  #sqlbar .row { display: flex; gap: 10px; margin-top: 8px;
                 align-items: center; }
  #sqlbar .hint { color: var(--muted); font-size: 12px; }
</style>
</head>
<body>
<header>
  <h1>quickwit-tpu</h1>
  <nav>
    <button id="tab-search" class="active">Search</button>
    <button id="tab-sql">SQL</button>
  </nav>
  <select id="index"></select>
  <input id="query" placeholder='query, e.g. severity_text:ERROR AND body:"disk full"'>
  <input id="maxhits" type="number" value="20" min="0" max="1000" style="width:80px">
  <input id="sortby" placeholder="sort, e.g. -timestamp" style="width:140px">
  <button id="go">Search</button>
</header>
<div id="sqlbar">
  <textarea id="sql" placeholder="SELECT severity_text, COUNT(*) AS n FROM hdfs-logs GROUP BY severity_text ORDER BY n DESC"></textarea>
  <div class="row">
    <button id="run-sql">Run</button>
    <span class="hint">Ctrl-Enter runs · GROUP BY / HAVING / window
      functions / JOIN / subqueries — see the docs</span>
  </div>
</div>
<main>
  <div id="meta"></div>
  <div id="error"></div>
  <div id="hits"></div>
  <div id="aggs"></div>
</main>
<script>
const $ = (id) => document.getElementById(id);
const esc = (s) => String(s).replace(/[&<>"']/g,
  (c) => ({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));
// request generation: a fetch resolving after a tab switch (or a newer
// request) must not write stale results into the visible panes
let gen = 0;
async function loadIndexes() {
  const my = gen;
  try {
    const res = await fetch('/api/v1/indexes');
    const indexes = await res.json();
    if (!res.ok) throw new Error(indexes.message || res.status);
    $('index').innerHTML = indexes.map(
      (ix) => `<option>${esc(ix.index_config.index_id)}</option>`).join('');
    if (!indexes.length && my === gen)
      $('error').textContent = 'no indexes yet';
  } catch (err) {
    if (my === gen)
      $('error').textContent = 'failed to list indexes: ' + err;
  }
}
async function search() {
  const my = ++gen;
  $('error').textContent = ''; $('hits').innerHTML = '';
  $('aggs').innerHTML = ''; $('meta').textContent = 'searching…';
  const params = new URLSearchParams({
    query: $('query').value || '*',
    max_hits: $('maxhits').value,
  });
  if ($('sortby').value) params.set('sort_by', $('sortby').value);
  const index = $('index').value;
  try {
    const res = await fetch(`/api/v1/${index}/search?` + params);
    const body = await res.json();
    if (my !== gen) return;
    if (!res.ok) { $('meta').textContent = '';
                   $('error').textContent = body.message || JSON.stringify(body);
                   return; }
    $('meta').textContent =
      `${body.num_hits} hits · ${(body.elapsed_time_micros / 1000).toFixed(1)} ms`;
    if (body.errors && body.errors.length) {
      $('error').textContent =
        'partial results — failures:\\n' + body.errors.join('\\n');
    }
    if (body.hits.length) {
      const rows = body.hits.map((h, i) =>
        `<tr><td>${i + 1}</td>` +
        `<td><pre>${esc(JSON.stringify(h, null, 1))}</pre></td></tr>`).join('');
      $('hits').innerHTML =
        `<table><tr><th>#</th><th>document</th></tr>${rows}</table>`;
    }
    if (body.aggregations) {
      $('aggs').innerHTML =
        `<h3>aggregations</h3><pre>${esc(JSON.stringify(body.aggregations, null, 2))}</pre>`;
    }
  } catch (err) {
    if (my !== gen) return;
    $('meta').textContent = ''; $('error').textContent = String(err);
  }
}
async function runSql() {
  const my = ++gen;
  $('error').textContent = ''; $('hits').innerHTML = '';
  $('aggs').innerHTML = ''; $('meta').textContent = 'running…';
  try {
    const res = await fetch('/api/v1/_sql', {
      method: 'POST', headers: {'Content-Type': 'application/json'},
      body: JSON.stringify({query: $('sql').value}),
    });
    const body = await res.json();
    if (my !== gen) return;
    if (!res.ok) { $('meta').textContent = '';
                   $('error').textContent = body.message || JSON.stringify(body);
                   return; }
    $('meta').textContent = `${body.rows.length} row(s)`;
    const head = body.columns.map((c) => `<th>${esc(c)}</th>`).join('');
    const rows = body.rows.map((r) =>
      `<tr>${r.map((v) => `<td>${v === null ? '<i>null</i>'
                           : esc(JSON.stringify(v))}</td>`).join('')}</tr>`
      ).join('');
    $('hits').innerHTML = `<table><tr>${head}</tr>${rows}</table>`;
  } catch (err) {
    if (my !== gen) return;
    $('meta').textContent = ''; $('error').textContent = String(err);
  }
}
function setMode(mode) {
  gen++;  // invalidate any in-flight request of the other tab
  const sql = mode === 'sql';
  $('tab-sql').classList.toggle('active', sql);
  $('tab-search').classList.toggle('active', !sql);
  $('sqlbar').style.display = sql ? 'block' : 'none';
  for (const id of ['index', 'query', 'maxhits', 'sortby', 'go'])
    $(id).style.display = sql ? 'none' : '';
  $('meta').textContent = ''; $('error').textContent = '';
  $('hits').innerHTML = ''; $('aggs').innerHTML = '';
}
$('go').onclick = search;
$('query').addEventListener('keydown', (e) => { if (e.key === 'Enter') search(); });
$('run-sql').onclick = runSql;
$('sql').addEventListener('keydown', (e) => {
  if (e.key === 'Enter' && (e.ctrlKey || e.metaKey)) runSql();
});
$('tab-search').onclick = () => setMode('search');
$('tab-sql').onclick = () => setMode('sql');
loadIndexes();
</script>
</body>
</html>
"""
