"""Static HTML UI for the demo app, served at GET / (this package's copy of
``outfitx_tpu/serve/ui.py``; no dependency beyond the browser)."""

_HTML = """<!doctype html>
<html><head><title>OutfitX-TPU demo</title>
<style>body{font-family:sans-serif;max-width:720px;margin:2em auto}
textarea{width:100%}pre{background:#f4f4f4;padding:1em}
#imgs img{margin:2px;border:1px solid #ccc}
.row{border:1px solid #ddd;margin:6px 0;padding:6px;border-radius:6px}
.chip{display:inline-block;background:#eee;border-radius:4px;margin:1px;
padding:2px 6px;font-size:12px}
.ok{color:#0a0}.bad{color:#c00}
.gt{outline:3px solid #0a0}.pick{outline:3px solid #c90}</style></head>
<body>
<h1>OutfitX-TPU demo</h1>
<p>Tasks: compatibility score (CP), complementary-item retrieval (CIR),
fill-in-the-blank (FITB). Enter item ids comma-separated.
<a href="#" onclick="sample()">sample a random outfit</a></p>
<h3>Outfit</h3><textarea id="outfit" rows="2"></textarea>
<h3>CP</h3><button onclick="cp()">score outfit</button>
<h3>CIR</h3>target item id: <input id="target">
<button onclick="cir()">retrieve top-10</button>
<h3>FITB</h3>candidates: <input id="cands" size="40">
<button onclick="fitb()">pick</button>
<h3>Browse test samples (ground truth vs prediction)</h3>
<button onclick="browse('cp')">CP samples</button>
<button onclick="browse('cir')">CIR samples</button>
<button onclick="browse('fitb')">FITB samples</button>
<div id="samples"></div>
<h3>Result</h3><div id="imgs"></div><pre id="out"></pre>
<script>
const out = (x) => {
  document.getElementById('out').textContent = JSON.stringify(x, null, 2);
  const div = document.getElementById('imgs'); div.innerHTML = '';
  for (const it of (x.items || []))
    if (it.image_url) {
      const img = document.createElement('img');
      img.src = it.image_url; img.width = 96; img.title =
        `#${it.item_id} ${it.description} (${it.score.toFixed(3)})`;
      div.appendChild(img);
    }
};
const ids = () => document.getElementById('outfit').value
  .split(',').map(s => parseInt(s.trim())).filter(Number.isFinite);
async function post(path, body) {
  const r = await fetch(path, {method:'POST', body: JSON.stringify(body)});
  out(await r.json());
}
async function sample() {
  const r = await fetch('/api/sample?n=4'); const j = await r.json();
  document.getElementById('outfit').value = j.outfit.join(', '); out(j);
}
const itemHtml = (it, cls) => it.image_url
  ? `<img class="${cls||''}" src="${it.image_url}" width="72"
       title="#${it.item_id} ${it.description}">`
  : `<span class="chip ${cls||''}">#${it.item_id}</span>`;
async function browse(task) {
  const r = await fetch(`/api/sample_${task}?n=4`); const j = await r.json();
  const div = document.getElementById('samples');
  if (!j.samples) { div.textContent = j.error || 'unavailable'; return; }
  div.innerHTML = j.samples.map(s => {
    if (task === 'cp')
      return `<div class="row"><b class="${(s.prob>0.5)==(s.label==1)?'ok':'bad'}">
        gt ${s.label} / prob ${s.prob.toFixed(3)}</b><br>
        ${s.items.map(i => itemHtml(i)).join('')}</div>`;
    if (task === 'cir')
      return `<div class="row"><b class="${s.gt_in_top10?'ok':'bad'}">
        gt ${s.gt_in_top10?'IN':'NOT in'} top-10</b><br>
        partial: ${s.partial_outfit.map(i => itemHtml(i)).join('')}<br>
        gt: ${itemHtml(s.gt_item,'gt')}
        retrieved: ${s.retrieved.map(i =>
          itemHtml(i, i.item_id===s.gt_item.item_id?'gt':'')).join('')}</div>`;
    return `<div class="row"><b class="${s.correct?'ok':'bad'}">
      ${s.correct?'correct':'wrong'} (gt ${s.answer_index}, picked
      ${s.predicted_index})</b><br>
      question: ${s.partial_outfit.map(i => itemHtml(i)).join('')}<br>
      candidates: ${s.candidates.map((c,k) => itemHtml(c,
        k===s.answer_index?'gt':(k===s.predicted_index?'pick':''))).join('')}
      </div>`;
  }).join('');
}
const cp = () => post('/api/cp', {outfit: ids()});
const cir = () => post('/api/cir', {outfit: ids(),
  target: parseInt(document.getElementById('target').value)});
const fitb = () => post('/api/fitb', {outfit: ids(),
  candidates: document.getElementById('cands').value.split(',')
    .map(s => parseInt(s.trim()))});
</script></body></html>"""
